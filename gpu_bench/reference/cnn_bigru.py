"""The family module of ``cnn_bigru_ser`` and ``cloak_grl``: everything the
training driver, the weights and the FLOP counts need of one model family,
found by the configuration's ``reference`` key (``harness/cell.py::family``;
this module where the key is absent).

A family module provides:

- ``leaves(cfg)``: ``{state_dict name: (shape, kind)}`` of the cell's task
  (``baseline``: one backbone; ``cloak_grl``: the noise and both backbones),
  ``init(cfg, name, kind, shape, n)``: a leaf's initial value from standard
  normals ``n``, and ``STATE_KINDS``, the kinds that are state, not
  parameters (never trained, left out of the change);
- ``backbone_kwargs(cfg)``: the keyword arguments of the program's
  ``build_backbone`` but ``pred`` and ``compute_dtype``;
- ``ingest_kwargs(cfg)``: those of the program's ``device_ingest`` but the
  frontend and the device, and ``windows(waves, speakers, rows, cfg)``, the
  reference's own windows from the same waves;
- ``noise_shape(cfg)``: the shape of one noise draw of the cloak;
- ``baseline_loss`` / ``grl_loss``, ``pinned_rows(name, cfg)`` and
  ``sgd_step(p, grads, bufs, opt, cfg)``: the reference's training step;
  ``Draws``, ``PRECISIONS`` and ``f32_off`` with it;
- ``train_flops_per_window(cfg)``: the FLOPs of a training window by task;
- ``counters()``: the program's launch counters that a traced run zeroes
  and reads, ``{key: (module, function, attribute)}``;
- ``TINY``: the sizes the CPU tests shrink a configuration to, and
  ``PUBLISHED``: the widths a configuration keeps unless it lists them in
  ``reduced``.

Like the rest of ``reference/``, it imports nothing of the program: the
counters are named, and the driver looks them up.
"""

from __future__ import annotations

import math

import torch

from gpu_bench.harness.counts import BLOCK1_KERNELS
from gpu_bench.reference import model as R
from gpu_bench.reference.features import ingest_windows
from gpu_bench.reference.model import PRECISIONS, Draws, baseline_loss, f32_off, grl_loss

__all__ = ["leaves", "init", "STATE_KINDS", "backbone_kwargs", "ingest_kwargs", "windows",
           "noise_shape", "baseline_loss", "grl_loss", "pinned_rows", "sgd_step", "Draws",
           "PRECISIONS", "f32_off", "layer_flops", "forward_flops", "train_flops_per_window",
           "counters", "TINY", "PUBLISHED"]

TINY = dict(hidden_size=8, feature_len=32, win_len=48, shift_len=12)
PUBLISHED = dict(hidden_size=64, feature_len=128, win_len=200, shift_len=50, n_fft=800,
                 channels=[32, 64, 128], kernel_size=5, num_rnn_layers=2, dense_size=128)
STATE_KINDS = ("bn_mean", "bn_var", "count")


def leaves(cfg: dict) -> dict:
    if cfg["task"] == "baseline":
        return R.leaf_shapes(cfg, cfg["pred"])
    if cfg["task"] == "cloak_grl":
        shape = noise_shape(cfg)
        out = {"noise.locs": (shape, "noise_loc"), "noise.rhos": (shape, "noise_rho")}
        out.update(R.leaf_shapes(cfg, "emotion", "emotion_backbone."))
        out.update(R.leaf_shapes(cfg, "gender", "gender_backbone."))
        return out
    raise ValueError(f"unknown task {cfg['task']!r}")


def init(cfg: dict, name: str, kind: str, shape, n: torch.Tensor) -> torch.Tensor:
    """Scaled by kind: BatchNorm gains near 1, shifts near 0 and running
    statistics that move the eval-mode activations (mean ~0.1, var 1 +
    ~0.25), so eval forwards are not the identity; a GRU's pinned rows 0."""
    fan = math.prod(shape[1:]) if len(shape) > 1 else 1
    if kind in ("conv_w", "dense_w", "rnn_ih", "rnn_hh"):
        t = n / math.sqrt(fan)
    elif kind in ("bias", "rnn_b", "rnn_bhh"):
        t = 0.05 * n
    elif kind == "bn_w":
        t = 1.0 + 0.1 * n
    elif kind in ("bn_b", "bn_mean"):
        t = 0.1 * n
    elif kind == "bn_var":
        t = 1.0 + 0.25 * n * n
    elif kind == "noise_loc":
        t = 0.05 * n
    elif kind == "noise_rho":
        t = -2.0 + 0.5 * n
    else:
        raise ValueError(kind)
    t = t.contiguous()
    rows = pinned_rows(name, cfg)
    if rows is not None:
        t[rows] = 0.0
    return t


def backbone_kwargs(cfg: dict) -> dict:
    return {"model_type": cfg["model_type"], "hidden_size": cfg["hidden_size"],
            "feature_len": cfg["feature_len"], "win_len": cfg["win_len"],
            "dropout_rate": cfg["dropout_rate"]}


def ingest_kwargs(cfg: dict) -> dict:
    return {"n_fft": cfg["n_fft"], "n_mels": cfg["feature_len"], "win_len": cfg["win_len"],
            "shift_len": cfg["shift_len"]}


def windows(waves: torch.Tensor, speakers: torch.Tensor, rows, cfg: dict) -> torch.Tensor:
    """The training windows ``rows`` of an ingest of (N, L) int16 waves,
    (len(rows), win_len, n_mels) float64: :func:`features.ingest_windows`."""
    return ingest_windows(waves, speakers, rows, cfg)


def noise_shape(cfg: dict) -> tuple:
    return (1, cfg["win_len"], cfg["feature_len"])


def pinned_rows(name: str, cfg: dict):
    return R.pinned_rows(name, cfg["hidden_size"])


def sgd_step(p: dict, grads: dict, bufs: dict, opt: dict, cfg: dict) -> None:
    R.sgd_step(p, grads, bufs, opt, cfg["hidden_size"])


def layer_flops(cfg: dict) -> dict:
    """FLOPs of one forward of a backbone on one window, by layer: the
    multiply-adds (2 each) of the convolutions, the GRU's input and hidden
    projections, dense1 and the head.  Elementwise work (BatchNorm, ReLU,
    pooling, the gates' nonlinearities, dropout, the noise) is left out."""
    k2 = cfg["kernel_size"] ** 2
    h_px, w_px, c_in = cfg["win_len"], cfg["feature_len"], 1
    out = {}
    for i, c in enumerate(cfg["channels"]):
        out[f"block{i + 1}"] = 2.0 * h_px * w_px * c * c_in * k2
        h_px, w_px, c_in = h_px // 2, w_px // 2, c
    hidden, steps = cfg["hidden_size"], h_px
    f_in = c_in * w_px
    for layer in range(cfg["num_rnn_layers"]):
        out[f"gru{layer + 1}"] = 2.0 * 2 * steps * 3 * hidden * (f_in + hidden)
        f_in = 2 * hidden
    n_cls = cfg["classes"][cfg.get("pred", "emotion")]
    out["heads"] = 2.0 * (2 * hidden * cfg["dense_size"] + cfg["dense_size"] * n_cls)
    return out


def forward_flops(cfg: dict) -> float:
    """F: one eval or train forward of a backbone on one window."""
    return sum(layer_flops(cfg).values())


def train_flops_per_window(cfg: dict) -> float:
    """One training step's FLOPs per window.  A backward is a weight
    gradient and an input gradient, each the forward's products again.

    - ``baseline``: forward + weight gradients + input gradients, less block
      1's input gradient (the windows are data): 3F - block1.
    - ``cloak_grl``: the frozen emotion backbone's forward and input
      gradient (2F, into the noise) and the gender backbone's forward,
      weight and input gradients (3F): 5F.
    """
    f = forward_flops(cfg)
    if cfg["task"] == "baseline":
        return 3.0 * f - layer_flops(cfg)["block1"]
    if cfg["task"] == "cloak_grl":
        return 5.0 * f
    raise ValueError(f"unknown task {cfg['task']!r}")


def counters() -> dict:
    """Block 1's launch counters, K1-K5 by mode: ``{(kernel, dtype):
    (module, function, attribute)}``, the keys ``block1_roofline`` reads."""
    return {(name, mode): ("sept_tpu_torch.ops.conv_block1", name, attr)
            for name in BLOCK1_KERNELS
            for mode, attr in (("float32", "launches"), ("bfloat16", "launches_bf16"))}
