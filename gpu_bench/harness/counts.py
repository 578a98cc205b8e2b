"""The yardstick's arithmetic: the chip's peaks and each kernel's least
time.  A model family's FLOPs are its family module's
(``reference/<family>.py``, ``train_flops_per_window``): the algorithm's
work from the published shapes, not what an implementation launches, so a
later change that fuses or removes a kernel reads against the same work.

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
