"""WavLM's gated-bias attention core: CUDA kernel wrapper, its plain version
and its autograd Function.

:func:`gated_bias_attention` takes the QKV product's output as it lies,
(B, T, 3 hidden) with q, k and v each (heads, hd) a row, the f32 gate (B, T,
heads), the f32 position bias (heads, T, T) and, in train mode, the bool
keep-mask (B, heads, T, T) of the attention dropout with its keep factor,
and returns the context (B, T, hidden) in qkv's dtype:
``softmax(q k^T / sqrt(hd) + gate[b, i, h] * bias[h, i, j])``, dropout, then
``P v``.  The plain version, :func:`gated_bias_attention_plain`, is the
composition ``models/wavlm.py`` ran until the kernel came: bf16 scores
taken to f32 and scaled, the gated bias added, the f32 softmax, the dropout
as ``where(mask, p / keep, 0)``, P rounded to qkv's dtype for its product
with v.  The JAX package has no WavLM, so no Pallas kernel computes it.

For a CUDA bf16 tensor the forward is one launch of ``csrc/attention.cu``'s
forward kernel, which reads q, k and v from qkv with no permute and no copy
and writes the context in place; the backward is one launch of its
backward kernel, which recomputes the probabilities and writes dq, dk and
dv into one (B, T, 3 hidden) gradient and the gate's gradient, and, where
the bias needs a gradient, its per-(b, h) partials, which a second launch
sums over the batch.  Nothing of the f32 scores or probabilities is kept
for the backward: qkv, the gate, the bias and the mask are.  Under
``torch.no_grad`` the forward saves nothing.

A CPU tensor takes the plain version under autograd, so its output and
gradients are the composition's bit for bit.  A CUDA tensor launches the
kernels or raises; nothing falls back to the composition.  Any T and head
dimension run (above 128 keys or 128 dims the kernels take their general
path).  ``gated_bias_attention.launches`` and ``.launches_bwd`` count the
forward and backward calls that launched the kernels, one a call.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from sept_tpu_torch.ops import cuda_lib

__all__ = ["gated_bias_attention", "gated_bias_attention_plain"]

_BF = torch.bfloat16


def gated_bias_attention_plain(qkv: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor,
                               heads: int, mask: Optional[torch.Tensor] = None,
                               keep: float = 1.0) -> torch.Tensor:
    """The attention core in torch ops, qkv's dtype throughout the products
    (f32 in the f32 model, bf16 in the bf16 one): (B, T, hidden)."""
    b, t, width = qkv.shape
    hidden = width // 3
    hd = hidden // heads
    qkv = qkv.view(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, heads, T, hd)
    scores = (torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / math.sqrt(hd))
              + gate.transpose(1, 2)[..., None] * bias)
    p = torch.softmax(scores, -1)
    if mask is not None:
        p = torch.where(mask, p / keep, torch.zeros_like(p))
    return torch.matmul(p.to(v.dtype), v).transpose(1, 2).reshape(b, t, hidden)


def _check(qkv, gate, bias, heads, mask) -> None:
    """Raise unless the op takes these tensors."""
    if qkv.dim() != 3 or qkv.dtype != _BF or qkv.shape[-1] % 3:
        raise ValueError(f"gated_bias_attention: qkv must be (B, T, 3 hidden) bfloat16, got "
                         f"{tuple(qkv.shape)} {qkv.dtype}")
    b, t, width = qkv.shape
    if heads < 1 or (width // 3) % heads:
        raise ValueError(f"gated_bias_attention: hidden {width // 3} is not a multiple of "
                         f"{heads} heads")
    want = {"gate": (gate, (b, t, heads), torch.float32),
            "bias": (bias, (heads, t, t), torch.float32)}
    if mask is not None:
        want["mask"] = (mask, (b, heads, t, t), torch.bool)
    for name, (x, shape, dtype) in want.items():
        if tuple(x.shape) != shape or x.dtype != dtype or x.device != qkv.device:
            raise ValueError(f"gated_bias_attention: {name} must be {shape} {dtype} on "
                             f"{qkv.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")


def _scalars(hd: int, keep: float):
    """The scale and 1 / keep as the composition's f32 operations on the
    card take them: f32(1 / sqrt(hd)), and f32(1) / f32(keep) (torch
    multiplies by the reciprocal of a scalar divisor)."""
    return float(np.float32(1.0 / math.sqrt(hd))), float(np.float32(1.0) / np.float32(keep))


def _forward_kernel(qkv, gate, bias, heads, mask, keep):
    """The forward on the card, contiguous inputs: one launch, (B, T,
    hidden) bf16."""
    b, t, width = qkv.shape
    hidden = width // 3
    ctx = torch.empty((b, t, hidden), dtype=_BF, device=qkv.device)
    if b and t:
        lib = cuda_lib.load("attention")
        scale, inv_keep = _scalars(hidden // heads, keep)
        err = lib.sept_attn_fwd(qkv.data_ptr(), gate.data_ptr(), bias.data_ptr(),
                                None if mask is None else mask.data_ptr(), ctx.data_ptr(), b, t,
                                heads, hidden // heads, scale, inv_keep, cuda_lib.stream_of(ctx))
        cuda_lib.check(lib, err, "gated_bias_attention forward")
        gated_bias_attention.launches += 1
    return ctx


def _backward_kernel(dctx, qkv, gate, bias, heads, mask, keep, need_bias: bool):
    """The backward on the card, contiguous inputs: ``(dqkv, dgate,
    dbias)``, dbias None unless ``need_bias``."""
    b, t, width = qkv.shape
    hidden, dev = width // 3, qkv.device
    hd = hidden // heads
    dqkv = torch.empty_like(qkv)
    dgate = torch.empty((b, t, heads), dtype=torch.float32, device=dev)
    dbias = torch.empty((heads, t, t), dtype=torch.float32, device=dev) if need_bias else None
    if not (b and t):
        return dqkv.zero_(), dgate.zero_(), None if dbias is None else dbias.zero_()
    lib = cuda_lib.load("attention")
    part = torch.empty((b, heads, t, t), dtype=torch.float32, device=dev) if need_bias else None
    n_stats = lib.sept_attn_stats_floats(b, t, heads, hd)
    stats = torch.empty(n_stats, dtype=torch.float32, device=dev) if n_stats else None
    scale, inv_keep = _scalars(hd, keep)
    err = lib.sept_attn_bwd(
        qkv.data_ptr(), gate.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), dctx.data_ptr(), dqkv.data_ptr(),
        dgate.data_ptr(), None if part is None else part.data_ptr(),
        None if dbias is None else dbias.data_ptr(), None if stats is None else stats.data_ptr(),
        b, t, heads, hd, scale, inv_keep, cuda_lib.stream_of(dqkv))
    cuda_lib.check(lib, err, "gated_bias_attention backward")
    gated_bias_attention.launches_bwd += 1
    return dqkv, dgate, dbias


class _GatedBiasAttention(torch.autograd.Function):
    """(qkv, gate, bias, mask) -> (B, T, hidden) bf16, differentiable in qkv,
    gate and bias, once (the backward is a kernel)."""

    @staticmethod
    def forward(ctx, qkv, gate, bias, mask, heads, keep):
        ctx.save_for_backward(qkv, gate, bias, mask)
        ctx.heads, ctx.keep = heads, keep
        return _forward_kernel(qkv, gate, bias, heads, mask, keep)

    @staticmethod
    @once_differentiable
    def backward(ctx, dctx):
        qkv, gate, bias, mask = ctx.saved_tensors
        dqkv, dgate, dbias = _backward_kernel(dctx.contiguous(), qkv, gate, bias, ctx.heads,
                                              mask, ctx.keep, ctx.needs_input_grad[2])
        return (dqkv if ctx.needs_input_grad[0] else None,
                dgate if ctx.needs_input_grad[1] else None, dbias, None, None, None)


def gated_bias_attention(qkv: torch.Tensor, gate: torch.Tensor, bias: torch.Tensor, heads: int,
                         mask: Optional[torch.Tensor] = None, keep: float = 1.0) -> torch.Tensor:
    """The attention core of a bf16 WavLM layer: (B, T, 3 hidden) bf16 qkv,
    (B, T, heads) f32 gate, (heads, T, T) f32 bias, the (B, heads, T, T)
    bool keep-mask (None: no dropout) and its keep factor -> (B, T, hidden)
    bf16, equal in arithmetic to :func:`gated_bias_attention_plain`.  A
    CUDA qkv launches the kernels; a CPU qkv runs the plain version."""
    _check(qkv, gate, bias, heads, mask)
    if qkv.device.type != "cuda":
        return gated_bias_attention_plain(qkv, gate, bias, heads, mask, keep)
    qkv, gate, bias = qkv.contiguous(), gate.contiguous(), bias.contiguous()
    mask = None if mask is None else mask.contiguous()
    if torch.is_grad_enabled() and any(x.requires_grad for x in (qkv, gate, bias)):
        return _GatedBiasAttention.apply(qkv, gate, bias, mask, heads, keep)
    return _forward_kernel(qkv, gate, bias, heads, mask, keep)


gated_bias_attention.launches = 0  # forward kernel launches since the last reset
gated_bias_attention.launches_bwd = 0  # backward kernel launches since the last reset
