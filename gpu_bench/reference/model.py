"""Plain PyTorch reference of the benchmark's two configurations.

``cnn_bigru_ser``: the reference repository's ``two_d_cnn_lstm`` with a GRU
(three blocks of 5x5 conv + BatchNorm + ReLU + 2x2 max pool + channel
dropout, 32/64/128 channels; a channel-major flatten; a 2-layer
bidirectional GRU; mean pooling; dense 128 + ReLU + dropout; the head).
``cloak_grl``: learned per-cell Gaussian noise before a frozen eval-mode
``cnn_bigru_ser`` and a trainable gender ``cnn_bigru_ser`` behind a
gradient-reversal layer, trained as one minimax loss.

Everything is written out from the published layer equations with plain
torch operations on parameter dictionaries: no module of the program, no
cuDNN RNN.  Parameters carry the reference repository's ``state_dict``
names (``conv.{0,5,10}`` conv, ``conv.{1,6,11}`` BatchNorm, ``rnn.*``,
``dense1``, ``pred_<task>_layer``), so the same dictionary loads into the
program.  Conventions that the published code leaves to its framework and
that the configurations state: BatchNorm running statistics decay as
``0.9 * ra + 0.1 * batch`` with the biased variance; a GRU has one bias a
gate for r and z (``bias_hh``'s r and z rows are 0 and take no gradient);
dropout masks are ``uniform < 1 - rate`` drawn from an explicit generator,
in forward order, and kept entries are divided by ``1 - rate`` rounded to
the activation's dtype.

``Precision`` says how products are computed: ``F32`` exactly as float32
with TF32 off; ``TF32`` rounds both operands of every convolution and
matrix product (forward and backward) to TF32's 10-bit mantissa, which is
what the card's TF32 mode computes.  TF32 is the control of the float32
cells.  ``BF16`` is the configuration's bf16 compute mode (flax's
``dtype=bfloat16``): operands and stored activations rounded to bf16 where
that mode rounds them (below), products summed in float32, BatchNorm's
moments and normalization and the GRU's carry in float32, parameters
float32.  ``FP8`` rounds at the same places to float8 e4m3 in the forward
(the backward passes straight through): the control of the bf16 cell.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F

__all__ = ["Precision", "F32", "TF32", "BF16", "FP8", "PRECISIONS", "round_tf32", "Draws", "leaf_shapes", "backbone_forward",
           "grl_forward", "weighted_ce", "baseline_loss", "grl_loss", "sgd_step",
           "noise_scales", "f32_off"]


def f32_off() -> None:
    """TF32 off for matmuls and cuDNN: the reference's float32 is float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to the nearest TF32 value (10 mantissa bits, ties away
    from zero, as the card's conversion)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Rounded to bf16 and read back in float32; the backward rounds the
    gradient there too, as bf16 storage does."""
    return x.to(torch.bfloat16).to(torch.float32)


class _Straight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """Rounded to float8 e4m3 in the forward, the gradient passed through."""
    return _Straight.apply(x, lambda t: t.to(torch.float8_e4m3fn).to(torch.float32))


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    operands: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    # the low-precision compute mode's rounding of operands and stored values
    store: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


F32 = Precision("float32")
TF32 = Precision("tf32", round_tf32)
BF16 = Precision("bfloat16", store=round_bf16)
FP8 = Precision("fp8_e4m3", store=round_fp8)
# a cell's compute dtype -> (the reference's precision, the control's)
PRECISIONS = {"float32": (F32, TF32), "bfloat16": (BF16, FP8)}


class _RoundedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, rnd):
        ctx.save_for_backward(x, w)
        ctx.rnd = rnd
        return F.conv2d(rnd(x), rnd(w), b, padding=w.shape[-1] // 2)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        rnd, pad = ctx.rnd, w.shape[-1] // 2
        gx = torch.nn.grad.conv2d_input(x.shape, rnd(w), rnd(g), padding=pad)
        gw = torch.nn.grad.conv2d_weight(rnd(x), w.shape, rnd(g), padding=pad)
        return gx, gw, g.sum((0, 2, 3)), None


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return rnd(a) @ rnd(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        rnd = ctx.rnd
        return rnd(g) @ rnd(b).transpose(-1, -2), rnd(a).transpose(-1, -2) @ rnd(g), None


def _conv(x, w, b, prec: Precision):
    if prec.operands is None:
        return F.conv2d(x, w, b, padding=w.shape[-1] // 2)
    return _RoundedConv.apply(x, w, b, prec.operands)


def _mm(a, b, prec: Precision):
    if prec.operands is None:
        return a @ b
    return _RoundedMatmul.apply(a, b, prec.operands)


def _linear(x, w, b, prec):
    return _mm(x, w.t(), prec) + b


class Draws:
    """Dropout keep-masks and noise draws from one generator, in call order."""

    def __init__(self, generator: torch.Generator):
        self.g = generator

    def keep(self, shape, rate: float) -> torch.Tensor:
        return torch.rand(shape, generator=self.g, device=self.g.device) < 1.0 - rate

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.g, device=self.g.device)


class _Reverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lam):
        ctx.lam = lam
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.lam * g, None


def leaf_shapes(cfg: dict, pred: str = "emotion", prefix: str = "") -> dict:
    """``{state_dict name: (shape, kind)}`` of one ``cnn_bigru_ser``
    backbone, kind one of conv_w, bias, bn_w, bn_b, bn_mean, bn_var, count,
    rnn_ih, rnn_hh, rnn_b, rnn_bhh, dense_w."""
    out = {}
    c_in, k = 1, cfg["kernel_size"]
    for i, c in enumerate(cfg["channels"]):
        conv, bn = f"{prefix}conv.{5 * i}", f"{prefix}conv.{5 * i + 1}"
        out[f"{conv}.weight"] = ((c, c_in, k, k), "conv_w")
        out[f"{conv}.bias"] = ((c,), "bias")
        out[f"{bn}.weight"] = ((c,), "bn_w")
        out[f"{bn}.bias"] = ((c,), "bn_b")
        out[f"{bn}.running_mean"] = ((c,), "bn_mean")
        out[f"{bn}.running_var"] = ((c,), "bn_var")
        out[f"{bn}.num_batches_tracked"] = ((), "count")
        c_in = c
    h = cfg["hidden_size"]
    feat = cfg["channels"][-1] * (cfg["feature_len"] // 2 ** len(cfg["channels"]))
    for layer in range(cfg["num_rnn_layers"]):
        f_in = feat if layer == 0 else 2 * h
        for sfx in ("", "_reverse"):
            out[f"{prefix}rnn.weight_ih_l{layer}{sfx}"] = ((3 * h, f_in), "rnn_ih")
            out[f"{prefix}rnn.weight_hh_l{layer}{sfx}"] = ((3 * h, h), "rnn_hh")
            out[f"{prefix}rnn.bias_ih_l{layer}{sfx}"] = ((3 * h,), "rnn_b")
            out[f"{prefix}rnn.bias_hh_l{layer}{sfx}"] = ((3 * h,), "rnn_bhh")
    d = cfg["dense_size"]
    out[f"{prefix}dense1.weight"] = ((d, 2 * h), "dense_w")
    out[f"{prefix}dense1.bias"] = ((d,), "bias")
    n_cls = cfg["classes"][pred]
    out[f"{prefix}pred_{pred}_layer.weight"] = ((n_cls, d), "dense_w")
    out[f"{prefix}pred_{pred}_layer.bias"] = ((n_cls,), "bias")
    return out


def _dropout(x, draws: Optional[Draws], shape, rate):
    if draws is None or rate == 0.0:
        return x
    keep = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    return torch.where(draws.keep(shape, rate), x / keep, torch.zeros_like(x))


def _gru_direction(x, w_ih, w_hh, b_ih, b_hh, prec):
    """One direction of a GRU layer over (B, T, F): (B, T, H)."""
    h_size = w_hh.shape[1]
    gi = _mm(x, w_ih.t(), prec) + b_ih  # (B, T, 3H)
    h = x.new_zeros((x.shape[0], h_size))
    outs = []
    for t in range(x.shape[1]):
        gh = _mm(h, w_hh.t(), prec) + b_hh
        r = torch.sigmoid(gi[:, t, :h_size] + gh[:, :h_size])
        z = torch.sigmoid(gi[:, t, h_size:2 * h_size] + gh[:, h_size:2 * h_size])
        n = torch.tanh(gi[:, t, 2 * h_size:] + r * gh[:, 2 * h_size:])
        h = (1.0 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs, 1)


def _gru_direction_lowp(x, w_ih, w_hh, b_ih, b_hh, r):
    """One direction of flax's ``GRUCell(dtype=bfloat16)``: each gate Dense
    rounds its input, kernel and bias and returns a rounded value; the gate
    sums, sigmoid and tanh are rounded; the carry h is float32 and
    ``(1 - z) * n`` (rounded) + ``z * h`` (float32)."""
    h_size = w_hh.shape[1]
    gi = r(r(r(x) @ r(w_ih).t()) + r(b_ih))
    h = x.new_zeros((x.shape[0], h_size))
    outs = []
    for t in range(x.shape[1]):
        g = gi[:, t]
        gh = r(r(r(h) @ r(w_hh).t()) + r(b_hh))
        rz = r(torch.sigmoid(r(g[:, :2 * h_size] + gh[:, :2 * h_size])))
        rg, z = rz[:, :h_size], rz[:, h_size:]
        n = r(torch.tanh(r(g[:, 2 * h_size:] + r(rg * gh[:, 2 * h_size:]))))
        h = r(r(1.0 - z) * n) + z * h
        outs.append(h)
    return torch.stack(outs, 1)


class _Block1ConvLowp(torch.autograd.Function):
    """Block 1's convolution in the low-precision mode: ``r(conv(r(x),
    r(w)) + b)`` forward; backward from the unrounded cotangent ``g`` of the
    stored output (BatchNorm's backward is float32): the weight and input
    gradients from rounded operands (``r(x)``, ``r(w)``, ``r(g)``), the bias
    gradient the float32 sum of ``g``."""

    @staticmethod
    def forward(ctx, x, w, b, r):
        ctx.save_for_backward(x, w)
        ctx.r = r
        with torch.no_grad():
            return r(F.conv2d(r(x), r(w), b, padding=w.shape[-1] // 2))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        r, pad = ctx.r, w.shape[-1] // 2
        with torch.no_grad():
            gx = torch.nn.grad.conv2d_input(x.shape, r(w), r(g), padding=pad)
            gw = torch.nn.grad.conv2d_weight(r(x), w.shape, r(g), padding=pad)
        return gx, gw, g.sum((0, 2, 3)), None


def _backbone_lowp(p, x, cfg, pred, draws, prefix, r):
    """Train-mode forward in the low-precision compute mode ``r``: block 1
    rounds x and the kernel, sums in float32, stores y rounded
    (:class:`_Block1ConvLowp`), takes the
    batch moments of the stored y (E[y^2] - E[y]^2) and stores relu(y *
    scale + shift) rounded before the pool; blocks 2-3 convolve rounded
    operands into a rounded output, add the rounded bias (rounded), and
    normalize in float32 (rounded); channel dropout divides by the keep
    rate rounded to bf16 (rounded); the GRU is
    :func:`_gru_direction_lowp`; pooling, dense1 and the head are float32."""
    eps, rate = cfg["bn_eps"], cfg["dropout_rate"]
    keep = torch.tensor(1.0 - rate, dtype=torch.bfloat16).item()

    def drop(t, shape):
        return torch.where(draws.keep(shape, rate), r(t / keep), torch.zeros_like(t))

    for i in range(len(cfg["channels"])):
        conv, bn = f"{prefix}conv.{5 * i}", f"{prefix}conv.{5 * i + 1}"
        w, b = p[f"{conv}.weight"], p[f"{conv}.bias"]
        gamma, beta = p[f"{bn}.weight"], p[f"{bn}.bias"]
        if i == 0:
            y = _Block1ConvLowp.apply(x, w, b, r)
            mean = y.mean((0, 2, 3))
            var = torch.clamp((y * y).mean((0, 2, 3)) - mean * mean, min=0.0)
            scale = gamma * torch.rsqrt(var + eps)
            shift = beta - mean * scale
            z = r(torch.relu(y * scale[:, None, None] + shift[:, None, None]))
        else:
            y = r(r(F.conv2d(x, r(w), padding=w.shape[-1] // 2)) + r(b)[:, None, None])
            mean = y.mean((0, 2, 3))
            var = torch.clamp((y * y).mean((0, 2, 3)) - mean * mean, min=0.0)
            mul = torch.rsqrt(var + eps) * gamma
            z = torch.relu(r((y - mean[:, None, None]) * mul[:, None, None]
                             + beta[:, None, None]))
        x = F.max_pool2d(z, 2)
        x = drop(x, (x.shape[0], x.shape[1], 1, 1))
    bsz, c, t, d = x.shape
    x = x.permute(0, 2, 1, 3).reshape(bsz, t, c * d)
    for layer in range(cfg["num_rnn_layers"]):
        if layer:
            x = _dropout(x, draws, x.shape, rate)
        w = {sfx: [p[f"{prefix}rnn.{k}_l{layer}{sfx}"]
                   for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
             for sfx in ("", "_reverse")}
        fwd = _gru_direction_lowp(x, *w[""], r)
        bwd = _gru_direction_lowp(x.flip(1), *w["_reverse"], r).flip(1)
        x = torch.cat([fwd, bwd], -1)
    z = torch.relu(_linear(x.mean(1), p[f"{prefix}dense1.weight"], p[f"{prefix}dense1.bias"],
                           F32))
    z = _dropout(z, draws, z.shape, rate)
    head = f"{prefix}pred_{pred}_layer"
    return _linear(z, p[f"{head}.weight"], p[f"{head}.bias"], F32)


def backbone_forward(p: dict, x: torch.Tensor, cfg: dict, pred: str, train: bool,
                     draws: Optional[Draws] = None, prefix: str = "",
                     prec: Precision = F32) -> torch.Tensor:
    """(B, 1, T, D) windows -> (B, classes) logits of one backbone.  Train
    mode normalizes with the batch's moments (biased variance) and draws
    dropout from ``draws``; eval mode uses the running statistics and no
    dropout.  Running statistics are not updated here."""
    if prec.store is not None:
        if not train:
            raise ValueError("the low-precision reference is of training steps only")
        return _backbone_lowp(p, x, cfg, pred, draws, prefix, prec.store)
    eps, rate = cfg["bn_eps"], cfg["dropout_rate"]
    for i in range(len(cfg["channels"])):
        conv, bn = f"{prefix}conv.{5 * i}", f"{prefix}conv.{5 * i + 1}"
        y = _conv(x, p[f"{conv}.weight"], p[f"{conv}.bias"], prec)
        if train:
            mean = y.mean((0, 2, 3))
            var = ((y - mean[:, None, None]) ** 2).mean((0, 2, 3))
        else:
            mean, var = p[f"{bn}.running_mean"], p[f"{bn}.running_var"]
        y = ((y - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]
             * p[f"{bn}.weight"][:, None, None] + p[f"{bn}.bias"][:, None, None])
        x = F.max_pool2d(torch.relu(y), 2)
        if train:
            x = _dropout(x, draws, (x.shape[0], x.shape[1], 1, 1), rate)
    b, c, t, d = x.shape
    x = x.permute(0, 2, 1, 3).reshape(b, t, c * d)
    for layer in range(cfg["num_rnn_layers"]):
        if layer and train:
            x = _dropout(x, draws, x.shape, rate)
        w = {sfx: [p[f"{prefix}rnn.{k}_l{layer}{sfx}"]
                   for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
             for sfx in ("", "_reverse")}
        fwd = _gru_direction(x, *w[""], prec)
        bwd = _gru_direction(x.flip(1), *w["_reverse"], prec).flip(1)
        x = torch.cat([fwd, bwd], -1)
    z = x.mean(1)
    z = torch.relu(_linear(z, p[f"{prefix}dense1.weight"], p[f"{prefix}dense1.bias"], prec))
    if train:
        z = _dropout(z, draws, z.shape, rate)
    head = f"{prefix}pred_{pred}_layer"
    return _linear(z, p[f"{head}.weight"], p[f"{head}.bias"], prec)


def noise_scales(p: dict, cfg: dict) -> torch.Tensor:
    lo, hi = cfg["noise_min_scale"], cfg["noise_max_scale"]
    return (1.0 + torch.tanh(p["noise.rhos"])) / 2.0 * (hi - lo) + lo


def grl_forward(p: dict, x: torch.Tensor, cfg: dict, eps: torch.Tensor,
                draws: Optional[Draws], prec: Precision = F32):
    """The cloak + GRL game: (emotion logits, gender logits) of (B, 1, T, D)
    windows under one noise draw ``eps`` (1, T, D), which already carries
    the noise's std.  The emotion backbone runs in eval mode; the gender
    backbone in train mode behind the reversal."""
    noised = (x[:, 0] + (p["noise.locs"] + noise_scales(p, cfg) * eps))[:, None]
    emo = backbone_forward(p, noised, cfg, "emotion", False, prefix="emotion_backbone.",
                           prec=prec)
    gen = backbone_forward(p, _Reverse.apply(noised, cfg["grl_lambda"]), cfg, "gender", True,
                           draws, prefix="gender_backbone.", prec=prec)
    return emo, gen


def weighted_ce(logits, labels, weights):
    """Per-row weighted cross-entropy over the rows of weight > 0."""
    nll = -torch.log_softmax(logits, -1).gather(-1, labels[:, None])[:, 0]
    return (nll * weights).sum() / torch.clamp((weights > 0).sum().to(logits.dtype), min=1.0)


def baseline_loss(p, x, labels, weights, cfg, draws, prec=F32):
    return weighted_ce(backbone_forward(p, x, cfg, cfg["pred"], True, draws, prec=prec),
                       labels, weights)


def grl_loss(p, x, labels_emo, labels_gen, weights, cfg, eps, draws, prec=F32):
    emo, gen = grl_forward(p, x, cfg, eps, draws, prec)
    loss = (weighted_ce(emo, labels_emo, weights)
            + cfg["gender_lambda"] * weighted_ce(gen, labels_gen, weights))
    return loss - cfg["scale_lambda"] * torch.log(noise_scales(p, cfg).mean())


def pinned_rows(name: str, hidden: int) -> Optional[slice]:
    """The rows of a leaf that hold no parameter: a GRU's r and z rows of
    ``bias_hh`` (one bias a gate lives in ``bias_ih``)."""
    return slice(0, 2 * hidden) if ".bias_hh_l" in name else None


def sgd_step(p: dict, grads: dict, bufs: dict, opt: dict, hidden: int) -> None:
    """SGD with momentum and L2 in the gradient, in place: ``d = g + wd * p``,
    ``buf = d`` on the first step else ``m * buf + d``, ``p -= lr * buf``."""
    with torch.no_grad():
        for name, g in grads.items():
            rows = pinned_rows(name, hidden)
            if rows is not None:
                g = g.clone()
                g[rows] = 0.0
            d = g + opt["weight_decay"] * p[name]
            bufs[name] = d.clone() if name not in bufs else opt["momentum"] * bufs[name] + d
            p[name] -= opt["learning_rate"] * bufs[name]
