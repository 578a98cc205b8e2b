"""First conv block of Conv2dBiRNN: CUDA kernel wrappers, their plain
versions, and the block's autograd Functions.

Counterpart of ``sept_tpu/ops/pallas_conv.py``.  Forward: K1
``_k1_conv_stats`` is :func:`block1_conv_stats`, K2 ``_k2_norm_pool`` is
:func:`block1_norm_pool`.  Backward: K3 ``_k3_route`` is :func:`block1_route`, K4
``_k4_grads`` is :func:`block1_weight_grads`, K5 ``_k5_dx`` is
:func:`block1_input_grad`.  All five are in ``csrc/conv_block1.cu``.
:class:`Block1Train` and :class:`Block1Eval` have
the semantics of ``fused_block1_train`` and ``fused_block1_eval``, with
``_core_bwd`` as their shared backward; :func:`block1_train_forward` and
:func:`block1_eval` apply them.  Layout is NCHW throughout.  Each wrapper
launches its kernel for CUDA tensors and runs its plain version for CPU
tensors; anything else raises.

``compute_dtype`` is the TPU kernels' ``cdtype``: ``torch.float32`` (the
default) or ``torch.bfloat16``.  In bf16 the conv output, the pooled values
and dy are bf16 tensors, and the kernels round at the TPU kernels' places:
K1 rounds x and the weights, sums in f32, rounds y once to store it, and
takes the moments of the stored values; K2 rounds relu(y * a + b) before the
2x2 max; K3 routes to the first maximum of those rounded values and reads
the pooled cotangent in bf16; K4 rounds dconv and x for the dW products
while db sums the unrounded dconv; K5 rounds dconv and the weights.  Sums,
moments, dW, db and dx are f32 in both modes, as are the parameters.  Each
wrapper counts its launches per mode: ``launches`` for float32,
``launches_bf16`` for bfloat16.

The backward launches K4 only when the weight or the bias needs a gradient,
and K5 only when ``x`` does: a baseline step (x is data) never runs K5, and a
frozen backbone (cloak) never runs K4, as XLA drops the unused TPU kernels.
Mean and variance get no gradient.

Sync-BN (the TPU kernels' ``axis_name``): :class:`Block1Train` takes a
data-parallel group (:class:`sept_tpu_torch.parallel.DataGroup`).  The
forward all-reduces K1's sums before the moments, which divide by the
global count, so K2 normalizes with the moments of the whole batch; the
backward all-reduces a copy of K3's sums before m1 and m2, so K4 and K5
take the global ones.  dgamma and dbeta stay the rank's own sums, as the
TPU kernel returns its shard's: the step's gradient all-reduce adds them
once.  The all-reduced sums over the global count equal JAX's ``pmean``
of per-shard means to float association, every shard holding the same
number of rows.  The collectives run between the kernels, and the plain
versions take the same path.
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
    "block1_route",
    "block1_route_plain",
    "block1_weight_grads",
    "block1_weight_grads_plain",
    "block1_input_grad",
    "block1_input_grad_plain",
    "Block1Train",
    "Block1Eval",
    "block1_eval",
    "block1_train_forward",
    "fold_bn",
]

EPS = 1e-5  # BatchNorm eps, as flax and torch
_ENTRY = {torch.float32: "", torch.bfloat16: "_bf16"}  # C entry point suffix


def _check_mode(compute_dtype, *stored):
    """``compute_dtype`` is a mode the kernels have, and the stored tensors
    (conv output, pooled cotangent, dy) are bf16 exactly in the bf16 mode."""
    if compute_dtype not in _ENTRY:
        raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, "
                         f"got {compute_dtype}")
    for t in stored:
        if (t.dtype == torch.bfloat16) != (compute_dtype == torch.bfloat16):
            raise TypeError(f"a {t.dtype} tensor where the {compute_dtype} mode stores "
                            f"{compute_dtype}")


def _count(fn, compute_dtype):
    if compute_dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


# The plain versions round where the bf16 mode rounds and nowhere else: in
# the f32 mode they compute in the dtype they are given (a float64 reference
# stays float64).
def _rounded(t, compute_dtype):
    """An operand rounded to bf16 and read back in f32 in the bf16 mode."""
    return t.to(compute_dtype).float() if compute_dtype == torch.bfloat16 else t


def _stored(t, compute_dtype):
    """A result as the mode stores it: rounded to bf16 in the bf16 mode."""
    return t.to(compute_dtype) if compute_dtype == torch.bfloat16 else t


def _wide(t):
    """A stored tensor in the dtype its arithmetic runs in (f32 for bf16)."""
    return t.float() if t.dtype == torch.bfloat16 else t


def _check_conv_args(x, weight, bias):
    if x.dim() != 4 or x.shape[1] != 1:
        raise ValueError(f"x must be (B, 1, H, W), got {tuple(x.shape)}")
    c = weight.shape[0]
    if tuple(weight.shape) != (c, 1, 5, 5) or tuple(bias.shape) != (c,):
        raise ValueError(f"weight must be (C, 1, 5, 5) and bias (C,), got "
                         f"{tuple(weight.shape)} and {tuple(bias.shape)}")


def block1_conv_stats_plain(x, weight, bias, compute_dtype=torch.float32):
    """conv 5x5 SAME + bias, stored in ``compute_dtype``, and (sum y, sum y^2)
    per channel of the stored values: (y, (2, C) f32)."""
    _check_conv_args(x, weight, bias)
    _check_mode(compute_dtype)
    y = _stored(tf.conv2d(_rounded(x, compute_dtype), _rounded(weight, compute_dtype), bias,
                          padding=2), compute_dtype)
    yr = _wide(y)
    return y, torch.stack([yr.sum((0, 2, 3)), (yr * yr).sum((0, 2, 3))])


def block1_conv_stats(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                      compute_dtype: torch.dtype = torch.float32):
    """K1: ``x`` (B, 1, H, W) f32, ``weight`` (C, 1, 5, 5), ``bias`` (C,) ->
    (conv output (B, C, H, W) in ``compute_dtype``, sums (2, C) f32) with
    sums[0] = sum of y and sums[1] = sum of y^2 per channel over batch and
    space."""
    dev = x.device
    if dev.type == "cpu":
        return block1_conv_stats_plain(x, weight, bias, compute_dtype)
    _check_conv_args(x, weight, bias)
    _check_mode(compute_dtype)
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
    y = torch.empty((b, c, h, w), dtype=compute_dtype, device=dev)
    sums = torch.zeros((2, c), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, sums
    scratch = torch.empty(lib.sept_conv_stats_scratch_floats(b, c, h, w),
                          dtype=torch.float32, device=dev)
    err = getattr(lib, "sept_conv_stats" + _ENTRY[compute_dtype])(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        sums.data_ptr(), scratch.data_ptr(), b, c, h, w, cuda_lib.stream_of(y))
    cuda_lib.check(lib, err, "block1_conv_stats")
    _count(block1_conv_stats, compute_dtype)
    return y, sums


block1_conv_stats.launches = 0  # float32-mode kernel launches since the last reset
block1_conv_stats.launches_bf16 = 0  # bfloat16-mode launches


def _check_pool_args(conv_out, scale, shift):
    if conv_out.dim() != 4 or conv_out.shape[2] < 2 or conv_out.shape[3] < 2:
        raise ValueError(f"conv_out must be (B, C, H>=2, W>=2), got "
                         f"{tuple(conv_out.shape)}")
    c = conv_out.shape[1]
    if tuple(scale.shape) != (c,) or tuple(shift.shape) != (c,):
        raise ValueError(f"scale and shift must be ({c},)")


def block1_norm_pool_plain(conv_out, scale, shift, compute_dtype=torch.float32):
    """relu(y * scale[c] + shift[c]) in f32, rounded to ``compute_dtype``,
    then 2x2 stride-2 max pool."""
    _check_pool_args(conv_out, scale, shift)
    _check_mode(compute_dtype, conv_out)
    z = _stored(torch.relu(_wide(conv_out) * scale[None, :, None, None]
                           + shift[None, :, None, None]), compute_dtype)
    return tf.max_pool2d(z, 2, 2)


def block1_norm_pool(conv_out: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor,
                     compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K2: (B, C, H, W) -> (B, C, H//2, W//2) in ``compute_dtype``, folded
    BatchNorm + ReLU + 2x2 max pool."""
    dev = conv_out.device
    if dev.type == "cpu":
        return block1_norm_pool_plain(conv_out, scale, shift, compute_dtype)
    _check_pool_args(conv_out, scale, shift)
    _check_mode(compute_dtype)
    b, c, h, w = conv_out.shape
    cuda_lib.require(conv_out, "block1_norm_pool conv_out", (b, c, h, w), dev,
                     compute_dtype)
    cuda_lib.require(scale, "block1_norm_pool scale", (c,), dev)
    cuda_lib.require(shift, "block1_norm_pool shift", (c,), dev)
    out = torch.empty((b, c, h // 2, w // 2), dtype=compute_dtype, device=dev)
    if out.numel() == 0:
        return out
    lib = cuda_lib.load("conv_block1")
    err = getattr(lib, "sept_norm_pool" + _ENTRY[compute_dtype])(
        conv_out.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), b, c, h,
        w, cuda_lib.stream_of(out))
    cuda_lib.check(lib, err, "block1_norm_pool")
    _count(block1_norm_pool, compute_dtype)
    return out


block1_norm_pool.launches = 0  # float32-mode kernel launches since the last reset
block1_norm_pool.launches_bf16 = 0  # bfloat16-mode launches


def _col(v):
    return v[None, :, None, None]


def _check_bwd_args(conv_out, *vecs):
    if conv_out.dim() != 4:
        raise ValueError(f"conv_out must be (B, C, H, W), got {tuple(conv_out.shape)}")
    c = conv_out.shape[1]
    if any(tuple(v.shape) != (c,) for v in vecs):
        raise ValueError(f"per-channel vectors must be ({c},)")


def block1_route_plain(conv_out, d_pooled, scale, shift, mean, inv,
                       compute_dtype=torch.float32):
    """K3's function: route each pooled cotangent to the first maximum of its
    2x2 window of relu(y * scale + shift) rounded to ``compute_dtype``
    (row-major), zero it where the f32 value y * scale + shift is <= 0, and
    reduce sum(dy) and sum(dy * xhat) per channel in f32 with xhat = (y -
    mean) * inv.  Returns (dy (B, C, H, W) in ``compute_dtype``, sums (2,
    C))."""
    _check_bwd_args(conv_out, scale, shift, mean, inv)
    _check_mode(compute_dtype, conv_out, d_pooled)
    b, c, h, w = conv_out.shape
    ho, wo = h // 2, w // 2
    y = _wide(conv_out)
    bn = y * _col(scale) + _col(shift)  # K2's rounding: no FMA
    z = _rounded(torch.relu(bn), compute_dtype)
    cells = z[:, :, :2 * ho, :2 * wo].reshape(b, c, ho, 2, wo, 2)
    cells = cells.permute(0, 1, 2, 4, 3, 5).reshape(b, c, ho, wo, 4)
    first = cells.argmax(-1, keepdim=True)  # the first maximum on ties
    routed = torch.zeros_like(cells).scatter_(-1, first, _wide(d_pooled)[..., None])
    dy = torch.zeros_like(y)
    dy[:, :, :2 * ho, :2 * wo] = routed.reshape(b, c, ho, wo, 2, 2).permute(
        0, 1, 2, 4, 3, 5).reshape(b, c, 2 * ho, 2 * wo)
    dy = torch.where(bn > 0, dy, torch.zeros_like(dy))
    xhat = (y - _col(mean)) * _col(inv)
    return _stored(dy, compute_dtype), torch.stack([dy.sum((0, 2, 3)),
                                                    (dy * xhat).sum((0, 2, 3))])


def block1_route(conv_out: torch.Tensor, d_pooled: torch.Tensor,
                 scale: torch.Tensor, shift: torch.Tensor, mean: torch.Tensor,
                 inv: torch.Tensor, compute_dtype: torch.dtype = torch.float32):
    """K3: conv output (B, C, H, W) and pooled cotangent (B, C, H//2, W//2),
    both in ``compute_dtype`` -> (dy (B, C, H, W) in ``compute_dtype``, sums
    (2, C) f32) with sums[0] = sum dy and sums[1] = sum dy * xhat per
    channel; see :func:`block1_route_plain`."""
    dev = conv_out.device
    if dev.type == "cpu":
        return block1_route_plain(conv_out, d_pooled, scale, shift, mean, inv,
                                  compute_dtype)
    _check_bwd_args(conv_out, scale, shift, mean, inv)
    _check_mode(compute_dtype)
    b, c, h, w = conv_out.shape
    cuda_lib.require(conv_out, "block1_route conv_out", (b, c, h, w), dev, compute_dtype)
    cuda_lib.require(d_pooled, "block1_route d_pooled", (b, c, h // 2, w // 2), dev,
                     compute_dtype)
    for name, v in (("scale", scale), ("shift", shift), ("mean", mean), ("inv", inv)):
        cuda_lib.require(v, f"block1_route {name}", (c,), dev)
    dy = torch.empty_like(conv_out)
    sums = torch.zeros((2, c), dtype=torch.float32, device=dev)
    if dy.numel() == 0:
        return dy, sums
    lib = cuda_lib.load("conv_block1")
    scratch = torch.empty(lib.sept_route_scratch_floats(b, c, h, w),
                          dtype=torch.float32, device=dev)
    err = getattr(lib, "sept_route" + _ENTRY[compute_dtype])(
        conv_out.data_ptr(), d_pooled.data_ptr(), scale.data_ptr(),
        shift.data_ptr(), mean.data_ptr(), inv.data_ptr(), dy.data_ptr(),
        sums.data_ptr(), scratch.data_ptr(), b, c, h, w, cuda_lib.stream_of(dy))
    cuda_lib.check(lib, err, "block1_route")
    _count(block1_route, compute_dtype)
    return dy, sums


block1_route.launches = 0  # float32-mode kernel launches since the last reset
block1_route.launches_bf16 = 0  # bfloat16-mode launches


def _dconv(conv_out, dy, ga, mean, inv, m1, m2):
    """The pre-BN cotangent ga * (dy - m1 - xhat * m2), as ``_dconv``."""
    xhat = (_wide(conv_out) - _col(mean)) * _col(inv)
    return _col(ga) * (_wide(dy) - _col(m1) - xhat * _col(m2))


def block1_weight_grads_plain(x, conv_out, dy, ga, mean, inv, m1, m2,
                              compute_dtype=torch.float32):
    """K4's function: (dW (C, 1, 5, 5), db (C,)) of the conv from the
    pre-BN cotangent, both f32.  dW is one f32 matmul of dconv against the
    5 x 5 patches of x, both rounded to ``compute_dtype`` (cuDNN's f32
    weight-gradient algorithms were measured up to 1e-3 relative off a
    float64 reference at ragged widths; see PERF.md); db sums the unrounded
    dconv."""
    _check_bwd_args(conv_out, ga, mean, inv, m1, m2)
    _check_mode(compute_dtype, conv_out, dy)
    b, c, h, w = conv_out.shape
    dconv = _dconv(conv_out, dy, ga, mean, inv, m1, m2)
    patches = tf.unfold(_rounded(x, compute_dtype), 5, padding=2)  # (B, 25, H*W)
    dw = torch.einsum("bcp,bkp->ck",
                      _rounded(dconv, compute_dtype).reshape(b, c, h * w), patches)
    return dw.reshape(c, 1, 5, 5), dconv.sum((0, 2, 3))


def block1_weight_grads(x: torch.Tensor, conv_out: torch.Tensor,
                        dy: torch.Tensor, ga: torch.Tensor, mean: torch.Tensor,
                        inv: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
                        compute_dtype: torch.dtype = torch.float32):
    """K4: x (B, 1, H, W) f32, conv output and dy (B, C, H, W) in
    ``compute_dtype``, per-channel ga = gamma * inv, mean, inv, m1, m2 ->
    (dW (C, 1, 5, 5), db (C,)) with dconv = ga * (dy - m1 - (y - mean) *
    inv * m2)."""
    dev = conv_out.device
    if dev.type == "cpu":
        return block1_weight_grads_plain(x, conv_out, dy, ga, mean, inv, m1, m2,
                                         compute_dtype)
    _check_bwd_args(conv_out, ga, mean, inv, m1, m2)
    _check_mode(compute_dtype)
    b, c, h, w = conv_out.shape
    cuda_lib.require(x, "block1_weight_grads x", (b, 1, h, w), dev)
    cuda_lib.require(conv_out, "block1_weight_grads conv_out", (b, c, h, w), dev,
                     compute_dtype)
    cuda_lib.require(dy, "block1_weight_grads dy", (b, c, h, w), dev, compute_dtype)
    for name, v in (("ga", ga), ("mean", mean), ("inv", inv), ("m1", m1), ("m2", m2)):
        cuda_lib.require(v, f"block1_weight_grads {name}", (c,), dev)
    lib = cuda_lib.load("conv_block1")
    smem = lib.sept_weight_grads_smem_bytes(c)
    if smem > cuda_lib.max_smem_per_block(dev):
        raise ValueError(f"block1_weight_grads: {c} channels need {smem} bytes "
                         "of shared memory a block, above the card's limit")
    grads = torch.zeros(c * 26, dtype=torch.float32, device=dev)  # dW, then db
    dw, db = grads[:c * 25].view(c, 1, 5, 5), grads[c * 25:]
    if conv_out.numel() == 0:
        return dw, db
    scratch = torch.empty(lib.sept_weight_grads_scratch_floats(b, c, h, w),
                          dtype=torch.float32, device=dev)
    err = getattr(lib, "sept_weight_grads" + _ENTRY[compute_dtype])(
        x.data_ptr(), conv_out.data_ptr(), dy.data_ptr(), ga.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), m1.data_ptr(), m2.data_ptr(),
        grads.data_ptr(), scratch.data_ptr(), b, c, h, w, cuda_lib.stream_of(grads))
    cuda_lib.check(lib, err, "block1_weight_grads")
    _count(block1_weight_grads, compute_dtype)
    return dw, db


block1_weight_grads.launches = 0  # float32-mode kernel launches since the last reset
block1_weight_grads.launches_bf16 = 0  # bfloat16-mode launches


def block1_input_grad_plain(conv_out, dy, weight, ga, mean, inv, m1, m2,
                            compute_dtype=torch.float32):
    """K5's function: dx (B, 1, H, W) f32, the pre-BN cotangent through the
    transposed conv (SAME borders), dconv and the weights rounded to
    ``compute_dtype``."""
    _check_bwd_args(conv_out, ga, mean, inv, m1, m2)
    _check_mode(compute_dtype, conv_out, dy)
    b, _, h, w = conv_out.shape
    dconv = _rounded(_dconv(conv_out, dy, ga, mean, inv, m1, m2), compute_dtype)
    return torch.nn.grad.conv2d_input((b, 1, h, w), _rounded(weight, compute_dtype),
                                      dconv, padding=2)


def block1_input_grad(conv_out: torch.Tensor, dy: torch.Tensor,
                      weight: torch.Tensor, ga: torch.Tensor, mean: torch.Tensor,
                      inv: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
                      compute_dtype: torch.dtype = torch.float32):
    """K5: conv output and dy (B, C, H, W) in ``compute_dtype``, weight (C, 1,
    5, 5) f32, the per-channel vectors of :func:`block1_weight_grads` -> dx
    (B, 1, H, W) f32."""
    dev = conv_out.device
    if dev.type == "cpu":
        return block1_input_grad_plain(conv_out, dy, weight, ga, mean, inv, m1, m2,
                                       compute_dtype)
    _check_bwd_args(conv_out, ga, mean, inv, m1, m2)
    _check_mode(compute_dtype)
    b, c, h, w = conv_out.shape
    cuda_lib.require(conv_out, "block1_input_grad conv_out", (b, c, h, w), dev,
                     compute_dtype)
    cuda_lib.require(dy, "block1_input_grad dy", (b, c, h, w), dev, compute_dtype)
    cuda_lib.require(weight, "block1_input_grad weight", (c, 1, 5, 5), dev)
    for name, v in (("ga", ga), ("mean", mean), ("inv", inv), ("m1", m1), ("m2", m2)):
        cuda_lib.require(v, f"block1_input_grad {name}", (c,), dev)
    lib = cuda_lib.load("conv_block1")
    smem = lib.sept_input_grad_smem_bytes(c)
    if smem > cuda_lib.max_smem_per_block(dev):
        raise ValueError(f"block1_input_grad: {c} channels need {smem} bytes "
                         "of shared memory a block, above the card's limit")
    dx = torch.empty((b, 1, h, w), dtype=torch.float32, device=dev)
    if dx.numel() == 0:
        return dx
    err = getattr(lib, "sept_input_grad" + _ENTRY[compute_dtype])(
        conv_out.data_ptr(), dy.data_ptr(), weight.data_ptr(), ga.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), m1.data_ptr(), m2.data_ptr(),
        dx.data_ptr(), b, c, h, w, cuda_lib.stream_of(dx))
    cuda_lib.check(lib, err, "block1_input_grad")
    _count(block1_input_grad, compute_dtype)
    return dx


block1_input_grad.launches = 0  # float32-mode kernel launches since the last reset
block1_input_grad.launches_bf16 = 0  # bfloat16-mode launches


def fold_bn(gamma, beta, mean, var, eps: float = EPS):
    """BatchNorm with the given statistics as one (scale, shift) pair."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def _batch_moments(sums, n):
    mean = sums[0] / n
    return mean, torch.clamp(sums[1] / n - mean * mean, min=0.0)


def _core_bwd(ctx, d_pooled, train: bool):
    """The shared backward: (dx, dW, db, dgamma, dbeta), each None where its
    input needs no gradient.  The pooled cotangent is read in the forward's
    ``compute_dtype``, as the TPU kernel reads it."""
    x, conv_out, weight, gamma, beta, mean, var = ctx.saved_tensors
    need_x, need_w, need_b, need_g, need_beta = ctx.needs_input_grad[:5]
    cd = ctx.compute_dtype
    ga, shift = fold_bn(gamma, beta, mean, var, ctx.eps)  # the forward's K2 pair
    inv = torch.rsqrt(var + ctx.eps)
    dy, red = block1_route(conv_out, d_pooled.to(cd).contiguous(), ga, shift, mean, inv, cd)
    if train:
        n = conv_out.shape[0] * conv_out.shape[2] * conv_out.shape[3]
        total = red
        if ctx.group is not None:  # sync-BN: the means over every rank's rows
            total = ctx.group.sum_(red.clone())
            n *= ctx.group.world_size
        m1, m2 = total[0] / n, total[1] / n
    else:
        m1 = m2 = torch.zeros_like(mean)
    dx = dw = db = None
    if need_w or need_b:
        dw, db = block1_weight_grads(x, conv_out, dy, ga, mean, inv, m1, m2, cd)
    if need_x:
        dx = block1_input_grad(conv_out, dy, weight, ga, mean, inv, m1, m2, cd)
    return (dx, dw if need_w else None, db if need_b else None,
            red[1] if need_g else None, red[0] if need_beta else None)


class Block1Train(torch.autograd.Function):
    """Train-mode block (batch-stat BN): (x, weight, bias, gamma, beta, eps[,
    compute_dtype[, group]]) -> (pooled, mean, var), pooled in
    ``compute_dtype`` and the variance biased, as ``fused_block1_train``.
    Mean and var are f32, for the running-average update, and carry no
    gradient.  With a data-parallel ``group`` the moments are those of
    every rank's rows (sync-BN; see the module docstring)."""

    @staticmethod
    def forward(ctx, x, weight, bias, gamma, beta, eps, compute_dtype=torch.float32,
                group=None):
        conv_out, sums = block1_conv_stats(x, weight, bias, compute_dtype)
        n = conv_out.shape[0] * conv_out.shape[2] * conv_out.shape[3]
        if group is not None:
            group.sum_(sums)
            n *= group.world_size
        mean, var = _batch_moments(sums, n)
        pooled = block1_norm_pool(conv_out, *fold_bn(gamma, beta, mean, var, eps),
                                  compute_dtype=compute_dtype)
        ctx.save_for_backward(x, conv_out, weight, gamma, beta, mean, var)
        ctx.eps, ctx.compute_dtype, ctx.group = eps, compute_dtype, group
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, d_pooled, _d_mean, _d_var):
        return _core_bwd(ctx, d_pooled, train=True) + (None, None, None)


class Block1Eval(torch.autograd.Function):
    """Eval-mode block (BN with the given statistics), differentiable in x,
    weight, bias, gamma and beta, as ``fused_block1_eval``; mean and var are
    constants.  Pooled values in ``compute_dtype``."""

    @staticmethod
    def forward(ctx, x, weight, bias, gamma, beta, mean, var, eps,
                compute_dtype=torch.float32):
        conv_out, _ = block1_conv_stats(x, weight, bias, compute_dtype)
        pooled = block1_norm_pool(conv_out, *fold_bn(gamma, beta, mean, var, eps),
                                  compute_dtype=compute_dtype)
        ctx.save_for_backward(x, conv_out, weight, gamma, beta, mean, var)
        ctx.eps, ctx.compute_dtype, ctx.group = eps, compute_dtype, None
        return pooled

    @staticmethod
    def backward(ctx, d_pooled):
        return _core_bwd(ctx, d_pooled, train=False) + (None, None, None, None)


def block1_eval(x, weight, bias, gamma, beta, mean, var, eps: float = EPS,
                compute_dtype: torch.dtype = torch.float32):
    """Eval-mode block: conv + BN(running stats) + ReLU + 2x2 max pool,
    (B, 1, H, W) -> (B, C, H//2, W//2) in ``compute_dtype``."""
    return Block1Eval.apply(x, weight, bias, gamma, beta, mean, var, eps, compute_dtype)


def block1_train_forward(x, weight, bias, gamma, beta, eps: float = EPS,
                         compute_dtype: torch.dtype = torch.float32, group=None):
    """Train-mode block: BN with the batch's own moments (every rank's rows
    with a data-parallel ``group``).  Returns (pooled, mean, var) with the
    biased variance, as ``_train_fwd``."""
    return Block1Train.apply(x, weight, bias, gamma, beta, eps, compute_dtype, group)
