"""The yardstick's arithmetic: the chip's peaks, the work the algorithms
need, counted from the published shapes, and each kernel's least time.

FLOPs count the multiply-adds (2 each) of the convolutions, the GRU's
input and hidden projections, dense1 and the head.  Elementwise work
(BatchNorm, ReLU, pooling, the gates' nonlinearities, dropout, the noise)
is left out, so a model-FLOP share reads a little low.  The counts are the
algorithm's, not what an implementation launches: a later change that fuses
or removes a kernel reads against the same work.

A kernel's least time is the larger of its operations over the peak rate
and its bytes over the memory bandwidth (each input read once, each output
written once): :func:`bound`.  Peaks are NVIDIA's data sheet for one H100
SXM at its full 700 W: 67 TFLOP/s float32 outside the tensor cores (TF32 is
off on the float32 path), 989 TFLOP/s dense bf16, 3.35 TB/s HBM3.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAKS = {"float32": PEAK_F32_FLOPS, "bfloat16": PEAK_BF16_FLOPS}


def bound(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS) -> float:
    """Least seconds of a kernel: max(operations / peak, bytes / bandwidth)."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def backbone_layers(cfg: dict) -> dict:
    """FLOPs of one forward of a ``cnn_bigru_ser`` backbone on one window,
    by layer."""
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
    return sum(backbone_layers(cfg).values())


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
        return 3.0 * f - backbone_layers(cfg)["block1"]
    if cfg["task"] == "cloak_grl":
        return 5.0 * f
    raise ValueError(f"unknown task {cfg['task']!r}")


# block 1's kernels, K1-K5, one launch on (batch, 1, H, W) windows and C
# channels: least work as the kernels' own tables state it (K1 conv + bias +
# moments; K2 BN affine + ReLU + 2x2 first-max pool; K3 the pool's routing,
# the ReLU mask and the two BN-backward sums; K4 the weight and bias
# gradients; K5 the input gradient).  bf16 mode: bf16 stored tensors (2
# bytes), bf16 operands at the bf16 peak.
BLOCK1_KERNELS = ("block1_conv_stats", "block1_norm_pool", "block1_route",
                  "block1_weight_grads", "block1_input_grad")


def block1_bound(kernel: str, batch: int, channels: int, h: int, w: int,
                 dtype: str = "float32") -> float:
    c, pix = channels, batch * h * w
    outs = pix * c
    if dtype == "float32":
        table = {
            "block1_conv_stats": (outs * (2 * 25 + 1 + 3), 4.0 * (pix + c * 26 + outs + 2 * c)),
            "block1_norm_pool": (3.0 * outs, 4.0 * (outs + 2 * c + outs // 4)),
            "block1_route": (9.0 * outs, 4.0 * (2 * outs + outs // 4 + 6 * c)),
            "block1_weight_grads": (outs * (5 + 2 * 25 + 1), 4.0 * (pix + 2 * outs + 31 * c)),
            "block1_input_grad": (outs * (5 + 2 * 25), 4.0 * (2 * outs + 30 * c + pix)),
        }
        peak = PEAK_F32_FLOPS
    else:
        table = {
            "block1_conv_stats": (outs * (2 * 25 + 1 + 3), 4.0 * (pix + 28 * c) + 2.0 * outs),
            "block1_norm_pool": (3.0 * outs, 2.0 * (outs + outs // 4) + 8.0 * c),
            "block1_route": (9.0 * outs, 2.0 * (2 * outs + outs // 4) + 24.0 * c),
            "block1_weight_grads": (outs * (5 + 2 * 25 + 1), 4.0 * (pix + 31 * c) + 4.0 * outs),
            "block1_input_grad": (outs * (5 + 2 * 25), 4.0 * (30 * c + pix) + 4.0 * outs),
        }
        peak = PEAK_BF16_FLOPS
    flops, nbytes = table[kernel]
    return bound(flops, nbytes, peak)
