"""The bf16 bidirectional GRU layer: CUDA kernel wrapper, its plain version
and its autograd Function.

:func:`bigru_lowp` computes exactly
:func:`sept_tpu_torch.models.backbone.bigru_layer_lowp`, flax's
``GRUCell(dtype=bfloat16)`` under ``nn.RNN`` in both directions, with every
rounding of that loop: the input projection ``bf16(bf16(x @ W_ih^T) +
b_ih)``; ``gh = bf16(bf16(bf16(h) @ W_hh^T) + b_hh)`` with the product summed
in f32; the gate sums, sigmoid and tanh in bf16; ``r * gh_n`` in bf16;
``bf16(bf16(1 - z) * n)``; the f32 carry ``... + z * h``.  The JAX
package's recurrence is flax's ``nn.RNN(GRUCell)``
(``sept_tpu/models/backbone.py:78``); no Pallas kernel computes it.

For a CUDA tensor the forward is one ``torch.matmul`` (the input
projection of every step and both directions) and one launch of
``csrc/gru_lowp.cu``'s forward recurrence, which writes the (B, T, 2H) f32
output in place and, when a gradient is wanted, the gates r, z, n and gh_n
(bf16) of every step.  The backward is one launch of the backward
recurrence, which writes each step's ``dgi`` and ``dgh`` rows (bf16) and
bf16(h_{t-1}), then one product each over all steps for the weight and
input gradients (``dW_hh = sum dgh_t^T bf16(h_{t-1})``, ``dW_ih = dgi^T x``,
``dx = dgi W_ih``) and the bias sums.  The backward rounds each cotangent
to bf16 where the loop's autograd holds it in a bf16 tensor and keeps it in
f32 where the loop's tensor is f32, so the gradients differ from the loop's
by the order of the products' sums alone (the loop sums ``dW_hh`` and
``db_hh`` in bf16 step by step; the products here round once).  Under
``torch.no_grad`` (validation, serving) the forward saves nothing.

A CPU tensor takes the plain version: the loop's own steps
(:func:`bigru_gi_lowp`, :func:`bigru_steps_lowp`, which
``bigru_layer_lowp`` runs too) saving the gates, then the hand-written
backward, so its output is the loop's bit for bit on the CPU.  A CUDA tensor
launches the kernels or raises; nothing falls back to the loop.  Any hidden
size runs (above 1024 the kernels' tiles take a scratch buffer).
``bigru_lowp.launches`` and ``bigru_lowp.launches_bwd`` count the forward
and backward kernel launches.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from sept_tpu_torch.ops import cuda_lib

__all__ = ["bigru_gi_lowp", "bigru_lowp", "bigru_lowp_backward_plain",
           "bigru_lowp_forward_plain", "bigru_steps_lowp"]

_BF = torch.bfloat16


def _check(x: torch.Tensor, weights, dtype) -> None:
    """Raise unless the op takes this layer."""
    if dtype != _BF:
        raise ValueError(f"bigru_lowp computes the bfloat16 GRU only, got {dtype}")
    if len(weights) != 8:
        raise ValueError(f"bigru_lowp: expected 8 weight tensors, got {len(weights)}")
    if x.dim() != 3 or x.dtype not in (torch.float32, _BF):
        raise ValueError(f"bigru_lowp: x must be (B, T, F) float32 or bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("bigru_lowp: x must be contiguous")
    _, t, f = x.shape
    if t == 0:
        raise ValueError("bigru_lowp: the sequence is empty")
    h = weights[1].shape[-1]
    shapes = ((3 * h, f), (3 * h, h), (3 * h,), (3 * h,)) * 2
    for w, shape in zip(weights, shapes):
        if tuple(w.shape) != shape or w.dtype != torch.float32 or w.device != x.device:
            raise ValueError(f"bigru_lowp: expected float32 weights of shapes {shapes} on "
                             f"{x.device}, got {[(tuple(v.shape), v.dtype) for v in weights]}")
        if not w.is_contiguous():
            raise ValueError("bigru_lowp: the weights must be contiguous")


def bigru_gi_lowp(x: torch.Tensor, weights, dtype: torch.dtype) -> torch.Tensor:
    """The input projections of every step of both directions, each in its
    own step order (the reverse one over the flipped input): (2, B, T, 3H)
    ``dtype``, flax's Dense with input, kernel and bias rounded to ``dtype``
    (the product rounded, then the bias added and rounded)."""
    w_ih = torch.stack([weights[0], weights[4]]).to(dtype)  # (2, 3H, F)
    b_ih = torch.stack([weights[2], weights[6]]).to(dtype)[:, None, None]
    xs = x.to(dtype)
    return torch.stack([xs, xs.flip(1)]) @ w_ih.transpose(1, 2)[:, None] + b_ih


def bigru_steps_lowp(gi: torch.Tensor, weights, dtype: torch.dtype, save: bool = False):
    """The recurrence of both directions from their input projections ``gi``
    (:func:`bigru_gi_lowp`) as a loop over the steps, flax's
    ``GRUCell(dtype)``: ``(out, gates)``, out (B, T, 2H) f32 in time order;
    gates (when ``save``) r, z, n and gh_n of every step, (4, 2, B, T, H)
    ``dtype``, each direction in its own step order.

    ``gh`` is ``dtype``'s product plus its bias; the gate sums, sigmoid and
    tanh are in ``dtype``; the carry h is f32 and ``h' = (1 - z) * n + z *
    h`` is f32 because ``z * h`` promotes."""
    hidden = weights[1].shape[1]
    w_hh = torch.stack([weights[1], weights[5]]).to(dtype).transpose(1, 2)  # (2, H, 3H)
    b_hh = torch.stack([weights[3], weights[7]]).to(dtype)[:, None]
    h = gi.new_zeros((2, gi.shape[1], hidden), dtype=torch.float32)
    outs, gates = [], []
    for t in range(gi.shape[2]):
        g = gi[:, :, t]
        gh = torch.bmm(h.to(dtype), w_hh) + b_hh  # the r, z rows of b_hh are 0
        rz = torch.sigmoid(g[..., :2 * hidden] + gh[..., :2 * hidden])
        r, z = rz[..., :hidden], rz[..., hidden:]
        gh_n = gh[..., 2 * hidden:]
        n = torch.tanh(g[..., 2 * hidden:] + r * gh_n)
        h = (1.0 - z) * n + z * h
        outs.append(h)
        if save:
            gates.append(torch.stack([r, z, n, gh_n]))
    out = torch.stack(outs, 2)  # (2, B, T, H)
    out = torch.cat([out[0], out[1].flip(1)], -1)
    return out, (torch.stack(gates, 3) if save else None)


def bigru_lowp_forward_plain(x: torch.Tensor, weights, save: bool):
    """The forward in torch ops, the loop's own steps: ``(out, saved)``, out
    (B, T, 2H) f32; ``saved`` (when ``save``) holds bf16 x and the gates of
    :func:`bigru_steps_lowp`."""
    out, gates = bigru_steps_lowp(bigru_gi_lowp(x, weights, _BF), weights, _BF, save)
    return out, ((x.to(_BF), gates) if save else None)


def _step_order(t: torch.Tensor) -> torch.Tensor:
    """(B, T, 2H) -> (2, B, T, H), each direction in its own step order."""
    hidden = t.shape[-1] // 2
    return torch.stack([t[..., :hidden], t[..., hidden:].flip(1)])


def _time_order(t: torch.Tensor) -> torch.Tensor:
    """(2, B, T, X), each direction in its own step order -> time order."""
    return torch.stack([t[0], t[1].flip(1)])


def bigru_lowp_backward_plain(dout: torch.Tensor, out: torch.Tensor, gates: torch.Tensor,
                              weights):
    """The backward recurrence in torch ops: ``(dgi, dgh, hb)`` as the
    kernel writes them, each step at its time index: dgi (B, T, 6H), dgh
    (2, B, T, 3H), hb = bf16(h_{t-1}) (2, B, T, H), all bf16.

    Each cotangent is rounded where the loop's autograd holds it in bf16,
    in the loop's order: the carry's cotangent (f32) is the output's plus
    ``dh' * z`` plus the bf16 ``dgh W_hh`` of the next step."""
    hidden = weights[1].shape[1]
    w_hh = torch.stack([weights[1], weights[5]]).to(_BF)  # (2, 3H, H)
    dout_s, h_s = _step_order(dout), _step_order(out)
    r, z, n, gh_n = gates.unbind(0)  # (2, B, T, H) each, step order
    h_prev = torch.cat([torch.zeros_like(h_s[:, :, :1]), h_s[:, :, :-1]], 2)
    dgi, dgh = [], []
    carry_a = carry_b = None
    for t in reversed(range(dout.shape[1])):
        dh = dout_s[:, :, t]
        if carry_a is not None:
            dh = (dh + carry_a) + carry_b.float()
        zt, nt, rt, hp = z[:, :, t], n[:, :, t], r[:, :, t], h_prev[:, :, t]
        dq = dh.to(_BF)
        dz = (dh * hp).to(_BF) + -(dq * nt)  # the z * h product, then 1 - z
        dn = dq * (1.0 - zt)
        da_n = torch.ops.aten.tanh_backward(dn, nt)
        dr = da_n * gh_n[:, :, t]
        d_gh_n = da_n * rt
        da_r = torch.ops.aten.sigmoid_backward(dr, rt)
        da_z = torch.ops.aten.sigmoid_backward(dz, zt)
        dgi.append(torch.cat([da_r, da_z, da_n], -1))
        dgh.append(torch.cat([da_r, da_z, d_gh_n], -1))
        carry_a = dh * zt
        carry_b = torch.bmm(dgh[-1], w_hh)
    dgi = _time_order(torch.stack(dgi[::-1], 2))  # (2, B, T, 3H)
    dgh = _time_order(torch.stack(dgh[::-1], 2))
    return torch.cat([dgi[0], dgi[1]], -1), dgh, _time_order(h_prev.to(_BF))


def _tiles(lib, b: int, hidden: int, backward: bool, device) -> torch.Tensor | None:
    """The kernels' A-tile scratch (bf16), needed above H 1024 only."""
    n = lib.sept_gru_lowp_tile_elems(b, hidden, int(backward))
    return torch.empty(n, dtype=_BF, device=device) if n else None


def _forward_kernel(x: torch.Tensor, weights, save: bool):
    """The forward on the card: the input projection, then one launch."""
    b, t, f = x.shape
    xs = x.to(_BF)
    w_ih = torch.cat([weights[0], weights[4]]).to(_BF)  # (6H, F): both directions
    gi = torch.matmul(xs.view(b * t, f), w_ih.t())  # (B*T, 6H), no bias
    out, gates = _forward_recurrence(gi, weights, b, t, save)
    return out, ((xs, w_ih, gates) if save else None)


def _forward_recurrence(gi: torch.Tensor, weights, b: int, t: int, save: bool):
    """The forward recurrence on the card, one launch: ``(out, gates)`` from
    ``gi`` (B*T, 6H) bf16 without the bias; gates None unless ``save``."""
    hidden, dev = weights[1].shape[1], gi.device
    out = torch.empty((b, t, 2 * hidden), dtype=torch.float32, device=dev)
    gates = torch.empty((2, b, t, 4, hidden), dtype=_BF, device=dev) if save else None
    if b:
        lib = cuda_lib.load("gru_lowp")
        tiles = _tiles(lib, b, hidden, False, dev)
        err = lib.sept_gru_lowp_fwd(
            gi.data_ptr(), *(weights[k].data_ptr() for k in (2, 6, 1, 5, 3, 7)),
            out.data_ptr(), gates.data_ptr() if save else None,
            tiles.data_ptr() if tiles is not None else None, b, t, hidden,
            cuda_lib.stream_of(out))
        cuda_lib.check(lib, err, "bigru_lowp forward")
        bigru_lowp.launches += 1
    return out, gates


def _gates_in_step_order(gates: torch.Tensor) -> torch.Tensor:
    """The forward kernel's gates (2, B, T, 4, H), each step at its time
    index, in the plain version's layout: (4, 2, B, T, H), each direction in
    its own step order."""
    g = gates.permute(3, 0, 1, 2, 4)
    return torch.stack([g[:, 0], g[:, 1].flip(2)], 1)


def _backward_kernel(dout: torch.Tensor, out: torch.Tensor, gates: torch.Tensor, weights):
    """The backward recurrence on the card: one launch, (dgi, dgh, hb)."""
    b, t, hidden = out.shape[0], out.shape[1], weights[1].shape[1]
    dev = out.device
    dgi = torch.empty((b, t, 6 * hidden), dtype=_BF, device=dev)
    dgh = torch.empty((2, b, t, 3 * hidden), dtype=_BF, device=dev)
    hb = torch.empty((2, b, t, hidden), dtype=_BF, device=dev)
    carry = torch.empty((2, b, 2, hidden), dtype=torch.float32, device=dev)  # the L2 path's
    if b:
        lib = cuda_lib.load("gru_lowp")
        tiles = _tiles(lib, b, hidden, True, dev)
        err = lib.sept_gru_lowp_bwd(
            dout.data_ptr(), out.data_ptr(), gates.data_ptr(), weights[1].data_ptr(),
            weights[5].data_ptr(), dgi.data_ptr(), dgh.data_ptr(), hb.data_ptr(),
            carry.data_ptr(), tiles.data_ptr() if tiles is not None else None, b, t, hidden,
            cuda_lib.stream_of(dgi))
        cuda_lib.check(lib, err, "bigru_lowp backward")
        bigru_lowp.launches_bwd += 1
    return dgi, dgh, hb


def _grads(needs, x_dtype, xs, w_ih, dgi, dgh, hb):
    """(dx, the 8 weight gradients) from the recurrence's rows: each one
    product or sum over all steps, rounded to bf16 once as the loop's bf16
    tensors hold them, then f32 (x's dtype for dx); None where not needed."""
    b, t, f = xs.shape
    hidden = hb.shape[-1]
    rows = dgi.view(b * t, 6 * hidden)
    dx = d_w_ih = d_b_ih = d_w_hh = d_b_hh = None
    if needs[0]:
        dx = (rows @ w_ih).view(b, t, f).to(x_dtype)
    if needs[1] or needs[5]:
        d_w_ih = (rows.t() @ xs.view(b * t, f)).float().view(2, 3 * hidden, f)
    if needs[3] or needs[7]:
        d_b_ih = rows.sum(0).float().view(2, 3 * hidden)
    if needs[2] or needs[6]:
        d_w_hh = torch.bmm(dgh.view(2, b * t, 3 * hidden).transpose(1, 2),
                           hb.view(2, b * t, hidden)).float()
    if needs[4] or needs[8]:
        d_b_hh = dgh.view(2, b * t, 3 * hidden).sum(1).float()
    grads = [dx]
    for k in (0, 1):
        grads += [g[k] if g is not None and needs[1 + 4 * k + i] else None
                  for i, g in enumerate((d_w_ih, d_w_hh, d_b_ih, d_b_hh))]
    return tuple(grads)


class _BiGRULowp(torch.autograd.Function):
    """(x, w_ih, w_hh, b_ih, b_hh, the reverse direction's four) -> (B, T,
    2H) f32, differentiable in all nine, once (the backward is a kernel)."""

    @staticmethod
    def forward(ctx, x, *weights):
        if x.device.type == "cuda":
            out, (xs, w_ih, gates) = _forward_kernel(x, weights, save=True)
        else:
            out, (xs, gates) = bigru_lowp_forward_plain(x, weights, save=True)
            w_ih = torch.cat([weights[0], weights[4]]).to(_BF)
        ctx.save_for_backward(xs, w_ih, gates, out, weights[1], weights[5])
        ctx.x_dtype = x.dtype
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        xs, w_ih, gates, out, w_hh_f, w_hh_r = ctx.saved_tensors
        weights = (None, w_hh_f, None, None, None, w_hh_r, None, None)
        dout = dout.contiguous()
        if dout.device.type == "cuda":
            rows = _backward_kernel(dout, out, gates, weights)
        else:
            rows = bigru_lowp_backward_plain(dout, out, gates, weights)
        return _grads(ctx.needs_input_grad, ctx.x_dtype, xs, w_ih, *rows)


def bigru_lowp(x: torch.Tensor, weights, dtype: torch.dtype = _BF) -> torch.Tensor:
    """One bidirectional bf16 GRU layer: (B, T, F) float32 or bfloat16 ->
    (B, T, 2H) f32, equal to ``bigru_layer_lowp(x, weights, dtype)``.

    ``weights`` are the layer's ``[weight_ih, weight_hh, bias_ih, bias_hh]``
    of the forward then the reverse direction (torch layout, gate rows r, z,
    n; f32, contiguous, on x's device).  Only ``dtype=torch.bfloat16``.  A
    CUDA x launches the kernels; a CPU x runs the plain version.  Without a
    gradient to compute, the forward saves nothing."""
    _check(x, weights, dtype)
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in weights)):
        return _BiGRULowp.apply(x, *weights)
    if x.device.type == "cuda":
        return _forward_kernel(x, weights, save=False)[0]
    return bigru_lowp_forward_plain(x, weights, save=False)[0]


bigru_lowp.launches = 0  # forward kernel launches since the last reset
bigru_lowp.launches_bwd = 0  # backward kernel launches since the last reset
