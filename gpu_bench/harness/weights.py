"""Seeded weights, made on the device in one draw.

The benchmark makes every weight itself, so the program and the plain
reference start from the same numbers: one ``torch.randn`` of all leaves
from a generator on the run's device, cut into the leaves and scaled by
kind.  The leaves and their scaling are the model family's
(``reference/<family>.py``: ``leaves`` and ``init``).
"""

from __future__ import annotations

import math

import torch

__all__ = ["make_weights"]


def make_weights(cfg: dict, family, seed: int, device) -> dict:
    """``{name: tensor}`` on ``device`` for the family's leaves of ``cfg``,
    from one generator seeded with ``seed``."""
    leaves = family.leaves(cfg)
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
        out[name] = family.init(cfg, name, kind, shape, flat[lo:lo + size].view(shape))
        lo += size
    return out
