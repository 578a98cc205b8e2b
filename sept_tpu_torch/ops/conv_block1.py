"""First conv block of Conv2dBiRNN, forward: CUDA kernel wrappers and their
plain versions.

Counterpart of the forward of ``sept_tpu/ops/pallas_conv.py``: K1
``_k1_conv_stats`` is :func:`block1_conv_stats`, K2 ``_k2_norm_pool`` is
:func:`block1_norm_pool`, and :func:`block1_eval` / :func:`block1_train_forward`
compose them as ``_fwd_core`` and ``_train_fwd`` do.  Layout is NCHW
throughout.  Each wrapper launches ``csrc/conv_block1.cu`` for CUDA tensors
and runs its plain version for CPU tensors; anything else raises.

The backward (K3-K5) is not ported yet; these functions carry no autograd.
"""

from __future__ import annotations

import torch
import torch.nn.functional as tf

from sept_tpu_torch.ops import cuda_lib

__all__ = [
    "EPS",
    "block1_conv_stats",
    "block1_conv_stats_plain",
    "block1_norm_pool",
    "block1_norm_pool_plain",
    "block1_eval",
    "block1_train_forward",
    "fold_bn",
]

EPS = 1e-5  # BatchNorm eps, as flax and torch


def _check_conv_args(x, weight, bias):
    if x.dim() != 4 or x.shape[1] != 1:
        raise ValueError(f"x must be (B, 1, H, W), got {tuple(x.shape)}")
    c = weight.shape[0]
    if tuple(weight.shape) != (c, 1, 5, 5) or tuple(bias.shape) != (c,):
        raise ValueError(f"weight must be (C, 1, 5, 5) and bias (C,), got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")


def block1_conv_stats_plain(x, weight, bias):
    """conv 5x5 SAME + bias, and (sum y, sum y^2) per channel: (y, (2, C))."""
    _check_conv_args(x, weight, bias)
    y = tf.conv2d(x, weight, bias, padding=2)
    return y, torch.stack([y.sum((0, 2, 3)), (y * y).sum((0, 2, 3))])


def block1_conv_stats(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor):
    """K1: ``x`` (B, 1, H, W) f32, ``weight`` (C, 1, 5, 5), ``bias`` (C,) ->
    (conv output (B, C, H, W), sums (2, C)) with sums[0] = sum of y and
    sums[1] = sum of y^2 per channel over batch and space."""
    dev = x.device
    if dev.type == "cpu":
        return block1_conv_stats_plain(x, weight, bias)
    _check_conv_args(x, weight, bias)
    b, _, h, w = x.shape
    c = weight.shape[0]
    cuda_lib.require(x, "block1_conv_stats x", (b, 1, h, w), dev)
    cuda_lib.require(weight, "block1_conv_stats weight", (c, 1, 5, 5), dev)
    cuda_lib.require(bias, "block1_conv_stats bias", (c,), dev)
    lib = cuda_lib.load("conv_block1")
    smem = lib.sept_conv_stats_smem_bytes(c)
    if smem > cuda_lib.max_smem_per_block(dev):
        raise ValueError(f"block1_conv_stats: {c} channels need {smem} bytes "
                         "of shared memory a block, above the card's limit")
    y = torch.empty((b, c, h, w), dtype=torch.float32, device=dev)
    sums = torch.zeros((2, c), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, sums
    scratch = torch.empty(lib.sept_conv_stats_scratch_floats(b, c, h, w),
                          dtype=torch.float32, device=dev)
    err = lib.sept_conv_stats(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        sums.data_ptr(), scratch.data_ptr(), b, c, h, w, cuda_lib.stream_of(y))
    cuda_lib.check(lib, err, "block1_conv_stats")
    block1_conv_stats.launches += 1
    return y, sums


block1_conv_stats.launches = 0  # kernel launches since the last reset


def _check_pool_args(conv_out, scale, shift):
    if conv_out.dim() != 4 or conv_out.shape[2] < 2 or conv_out.shape[3] < 2:
        raise ValueError(f"conv_out must be (B, C, H>=2, W>=2), got "
                         f"{tuple(conv_out.shape)}")
    c = conv_out.shape[1]
    if tuple(scale.shape) != (c,) or tuple(shift.shape) != (c,):
        raise ValueError(f"scale and shift must be ({c},)")


def block1_norm_pool_plain(conv_out, scale, shift):
    """relu(y * scale[c] + shift[c]), then 2x2 stride-2 max pool."""
    _check_pool_args(conv_out, scale, shift)
    z = torch.relu(conv_out * scale[None, :, None, None]
                   + shift[None, :, None, None])
    return tf.max_pool2d(z, 2, 2)


def block1_norm_pool(conv_out: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor) -> torch.Tensor:
    """K2: (B, C, H, W) -> (B, C, H//2, W//2), folded BatchNorm + ReLU +
    2x2 max pool."""
    dev = conv_out.device
    if dev.type == "cpu":
        return block1_norm_pool_plain(conv_out, scale, shift)
    _check_pool_args(conv_out, scale, shift)
    b, c, h, w = conv_out.shape
    cuda_lib.require(conv_out, "block1_norm_pool conv_out", (b, c, h, w), dev)
    cuda_lib.require(scale, "block1_norm_pool scale", (c,), dev)
    cuda_lib.require(shift, "block1_norm_pool shift", (c,), dev)
    out = torch.empty((b, c, h // 2, w // 2), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load("conv_block1")
    err = lib.sept_norm_pool(conv_out.data_ptr(), scale.data_ptr(),
                             shift.data_ptr(), out.data_ptr(), b, c, h, w,
                             cuda_lib.stream_of(out))
    cuda_lib.check(lib, err, "block1_norm_pool")
    block1_norm_pool.launches += 1
    return out


block1_norm_pool.launches = 0  # kernel launches since the last reset


def fold_bn(gamma, beta, mean, var, eps: float = EPS):
    """BatchNorm with the given statistics as one (scale, shift) pair."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def block1_eval(x, weight, bias, gamma, beta, mean, var, eps: float = EPS):
    """Eval-mode block: conv + BN(running stats) + ReLU + 2x2 max pool,
    (B, 1, H, W) -> (B, C, H//2, W//2)."""
    conv_out, _ = block1_conv_stats(x, weight, bias)
    return block1_norm_pool(conv_out, *fold_bn(gamma, beta, mean, var, eps))


def block1_train_forward(x, weight, bias, gamma, beta, eps: float = EPS):
    """Train-mode forward: BN with the batch's own moments.  Returns
    (pooled, mean, var) with the biased variance, as ``_train_fwd``."""
    conv_out, sums = block1_conv_stats(x, weight, bias)
    n = conv_out.shape[0] * conv_out.shape[2] * conv_out.shape[3]
    mean = sums[0] / n
    var = torch.clamp(sums[1] / n - mean * mean, min=0.0)
    return block1_norm_pool(conv_out, *fold_bn(gamma, beta, mean, var, eps)), mean, var
