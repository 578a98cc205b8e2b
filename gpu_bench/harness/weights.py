"""Seeded weights, made on the device in one draw.

The benchmark makes every weight itself, so the program and the plain
reference start from the same numbers: one ``torch.randn`` of all leaves
from a generator on the run's device, cut into the leaves and scaled by
kind.  BatchNorm gets gains near 1, shifts near 0 and running statistics
that move the eval-mode activations (mean ~0.1, var 1 + ~0.25), so eval
forwards are not the identity.  A GRU's pinned r / z rows of ``bias_hh``
stay 0.
"""

from __future__ import annotations

import math

import torch

from gpu_bench.reference.model import leaf_shapes, pinned_rows

__all__ = ["make_weights", "grl_leaves"]


def grl_leaves(cfg: dict) -> dict:
    shape = (1, cfg["win_len"], cfg["feature_len"])
    out = {"noise.locs": (shape, "noise_loc"), "noise.rhos": (shape, "noise_rho")}
    out.update(leaf_shapes(cfg, "emotion", "emotion_backbone."))
    out.update(leaf_shapes(cfg, "gender", "gender_backbone."))
    return out


def _scaled(kind: str, shape, n: torch.Tensor) -> torch.Tensor:
    fan = math.prod(shape[1:]) if len(shape) > 1 else 1
    if kind in ("conv_w", "dense_w", "rnn_ih", "rnn_hh"):
        return n / math.sqrt(fan)
    if kind in ("bias", "rnn_b", "rnn_bhh"):
        return 0.05 * n
    if kind == "bn_w":
        return 1.0 + 0.1 * n
    if kind in ("bn_b", "bn_mean"):
        return 0.1 * n
    if kind == "bn_var":
        return 1.0 + 0.25 * n * n
    if kind == "noise_loc":
        return 0.05 * n
    if kind == "noise_rho":
        return -2.0 + 0.5 * n
    raise ValueError(kind)


def make_weights(leaves: dict, seed: int, device, hidden: int) -> dict:
    """``{name: tensor}`` on ``device`` for ``leaves`` (name -> (shape,
    kind)), from one generator seeded with ``seed``."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    names = sorted(leaves)
    sizes = [math.prod(leaves[k][0]) for k in names]
    flat = torch.randn(sum(sizes), generator=g, device=dev)
    out, lo = {}, 0
    for name, size in zip(names, sizes):
        shape, kind = leaves[name]
        if kind == "count":
            out[name] = torch.zeros((), dtype=torch.long, device=dev)
            continue
        t = _scaled(kind, shape, flat[lo:lo + size].view(shape)).contiguous()
        rows = pinned_rows(name, hidden)
        if rows is not None:
            t[rows] = 0.0
        out[name] = t
        lo += size
    return out
