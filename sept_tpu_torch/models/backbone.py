"""Conv2dBiRNN in PyTorch, eval and train mode.

Counterpart of ``sept_tpu/models/backbone.py::Conv2dBiRNN`` and its pieces
(``_conv_block``, ``_FusedBN0``, ``_flatten_channel_major``, ``StackedBiRNN``,
``AttentionPool``, ``_Heads``).  Layout is NCHW: windows enter as
(B, 1, win_len, feature_len).  Parameter names are the reference's
``two_d_cnn_lstm`` state_dict keys (``conv.{0,5,10}`` conv, ``conv.{1,6,11}``
BatchNorm, ``rnn.*`` an ``nn.GRU`` (it holds the weights; its forward is
never called), ``att_linear{1,2}``, ``dense1``,
``pred_emotion_layer`` / ``pred_gender_layer``), so a reference checkpoint or
:mod:`sept_tpu_torch.compat.from_jax` output strict-loads.

The first conv block runs through the hand-written CUDA kernels of
:mod:`sept_tpu_torch.ops.conv_block1` (``Block1Train`` / ``Block1Eval``,
forward and backward); blocks 2-3 are ``F.conv2d`` + BatchNorm + ReLU +
``F.max_pool2d`` (the JAX package leaves them to XLA, outside any Pallas
kernel).

``compute_dtype`` is the JAX model's ``dtype`` knob (the CLIs'
``--compute_dtype``): ``torch.float32`` (the default) or ``torch.bfloat16``.
Parameters and running statistics stay f32 in both.  In bf16, as flax with
``dtype=bfloat16`` and ``conv_backend="fused1"``:

- block 1 runs the kernels' bf16 mode and returns bf16 pooled values; the
  channel dropout after each block is bf16;
- blocks 2-3 convolve in bf16 (input, weight and bias rounded; the bias is
  added to the rounded output), and BatchNorm computes its batch moments in
  f32 from the bf16 input (flax's ``force_float32_reductions``: mean and
  E[x^2] - mean^2, the biased variance, which the running statistics take)
  and the normalization ``(x - mean) * (rsqrt(var + eps) * gamma) + beta``
  in f32, rounded to bf16;
- the GRU follows ``nn.RNN(nn.GRUCell(dtype=bfloat16))``: the gate Dense
  layers round their inputs, kernels and biases to bf16 and return bf16, the
  carry stays f32 and ``h' = (1 - z) * n + z * h`` is promoted to f32
  (:func:`bigru_layer_lowp`; cuDNN's bf16 GRU would keep a bf16 hidden
  state).  One matmul gives the input projections of all steps, then a loop
  over the steps runs the recurrence, both directions at once;
- ``encode`` returns f32, and pooling, attention, ``dense1`` and the heads
  are f32.

Train mode follows the JAX package, not torch's modules:

- every BatchNorm normalizes with the batch's moments and updates its running
  statistics as flax does: ``ra = 0.9 * ra + 0.1 * batch`` with the BIASED
  batch variance (torch's ``F.batch_norm`` would store the unbiased one);
- dropout masks come from the :class:`DropoutDraws` the caller passes (an
  explicit ``torch.Generator``), never from torch's global generator: a
  (B, C, 1, 1) channel mask after each conv block, an elementwise mask
  between the GRU layers and after ``dense1``; the 2-layer BiGRU therefore
  runs, in every mode, as one single-layer call per layer on that layer's
  own ``rnn.*_l{L}`` weights;
- the GRU's ``bias_hh[0:2H]`` (the r and z rows) starts at 0 and is pinned
  there by a gradient hook.  flax's ``GRUCell`` has one bias for r and one
  for z, and
  :mod:`~sept_tpu_torch.compat.from_jax` puts each wholly in ``bias_ih``; if
  torch also trained the ``bias_hh`` rows, each gate's bias would move at
  twice the JAX rate.

Only ``2d-cnn-lstm`` and ``cnn-lstm-att`` are ported.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as tf
from torch import nn

from sept_tpu_torch.ops.conv_block1 import block1_eval, block1_train_forward

__all__ = ["Conv2dBiRNN", "DropoutDraws", "NUM_EMO_CLASSES", "NUM_GENDER_CLASSES",
           "bigru_layer_lowp", "flatten_channel_major"]

NUM_EMO_CLASSES = 4  # neu / hap / sad / ang
NUM_GENDER_CLASSES = 2  # F / M
_CHANNELS = (32, 64, 128)
_N_HEADS = 16
_MOMENTUM = 0.9  # flax convention: ra = 0.9 * ra + 0.1 * batch (torch's 0.1)


def flatten_channel_major(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T', D') -> (B, T', C*D'), channel-major (the reference's
    ``transpose(1, 2).reshape``)."""
    b, c, t, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, c * d)


class DropoutDraws:
    """The dropout masks of one train-mode forward, drawn in call order from
    an explicit ``torch.Generator``.  :meth:`replay` hands the same masks to
    a second forward on inputs of the same shapes (the antithetic pair)."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self._masks: list[torch.Tensor] = []
        self._next = 0

    def replay(self) -> "DropoutDraws":
        self._next = 0
        return self

    def keep(self, shape: tuple, rate: float) -> torch.Tensor:
        """Boolean keep-mask of ``shape``, each entry kept with 1 - rate."""
        if self._next == len(self._masks):
            u = torch.rand(shape, generator=self.generator, device=self.generator.device)
            self._masks.append(u < 1.0 - rate)
        mask = self._masks[self._next]
        if tuple(mask.shape) != tuple(shape):
            raise ValueError(f"replayed dropout mask {tuple(mask.shape)} != {tuple(shape)}")
        self._next += 1
        return mask


def _pin_rz_rows(grad: torch.Tensor, hidden: int) -> torch.Tensor:
    return torch.cat([torch.zeros_like(grad[:2 * hidden]), grad[2 * hidden:]])


def bigru_layer_lowp(x: torch.Tensor, weights, dtype: torch.dtype) -> torch.Tensor:
    """One bidirectional GRU layer computed as flax's ``GRUCell(dtype=dtype)``
    under ``nn.RNN`` (forward, and backward over the reversed sequence with
    its outputs put back in order): (B, T, F) -> (B, T, 2H) f32.

    ``weights`` are the layer's ``[weight_ih, weight_hh, bias_ih, bias_hh]``
    of the forward then the reverse direction, torch layout (gate rows r, z,
    n).  Each gate's Dense rounds input, kernel and bias to ``dtype`` and
    returns ``dtype`` (the product rounded, then the bias added and rounded);
    the sums, sigmoid and tanh of the gates are in ``dtype``; the carry h is
    f32 and ``h' = (1 - z) * n + z * h`` is f32 because ``z * h`` promotes."""
    hidden = weights[1].shape[1]
    w_ih = torch.stack([weights[0], weights[4]]).to(dtype)          # (2, 3H, F)
    w_hh = torch.stack([weights[1], weights[5]]).to(dtype).transpose(1, 2)  # (2, H, 3H)
    b_ih = torch.stack([weights[2], weights[6]]).to(dtype)[:, None, None]
    b_hh = torch.stack([weights[3], weights[7]]).to(dtype)[:, None]
    xs = x.to(dtype)
    # input projections of every step, both directions: (2, B, T, 3H)
    gi = torch.stack([xs, xs.flip(1)]) @ w_ih.transpose(1, 2)[:, None] + b_ih
    h = x.new_zeros((2, x.shape[0], hidden), dtype=torch.float32)
    outs = []
    for t in range(x.shape[1]):
        g = gi[:, :, t]
        gh = torch.bmm(h.to(dtype), w_hh) + b_hh  # the r, z rows of b_hh are 0
        rz = torch.sigmoid(g[..., :2 * hidden] + gh[..., :2 * hidden])
        r, z = rz[..., :hidden], rz[..., hidden:]
        n = torch.tanh(g[..., 2 * hidden:] + r * gh[..., 2 * hidden:])
        h = (1.0 - z) * n + z * h
        outs.append(h)
    out = torch.stack(outs, 2)  # (2, B, T, H)
    return torch.cat([out[0], out[1].flip(1)], -1)


class Conv2dBiRNN(nn.Module):
    """Three conv blocks (32/64/128 channels, 5x5, BN, ReLU, 2x2 max pool,
    channel dropout), channel-major flatten, 2-layer BiGRU, mean or 16-head
    attention pooling, dense 128, task head(s)."""

    def __init__(self, hidden_size: int = 64, feature_len: int = 128,
                 pred: str = "emotion", att: Optional[str] = None,
                 attention_size: int = 128, num_rnn_layers: int = 2,
                 dropout_rate: float = 0.2, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if pred not in ("emotion", "gender", "multitask"):
            raise ValueError(f"unknown pred: {pred!r}")
        if att not in (None, "self_att"):
            raise ValueError(f"unknown att: {att!r}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, "
                             f"got {compute_dtype}")
        self.pred, self.att, self.dropout_rate = pred, att, dropout_rate
        self.compute_dtype = compute_dtype
        layers = []
        c_in = 1
        for c in _CHANNELS:
            layers += [nn.Conv2d(c_in, c, 5, padding=2), nn.BatchNorm2d(c),
                       nn.ReLU(), nn.MaxPool2d(2), nn.Dropout2d(dropout_rate)]
            c_in = c
        self.conv = nn.Sequential(*layers)
        d_out = feature_len // 2 ** len(_CHANNELS)
        self.rnn = nn.GRU(_CHANNELS[-1] * d_out, hidden_size,
                          num_layers=num_rnn_layers, batch_first=True,
                          bidirectional=True, dropout=dropout_rate)
        for name, p in self.rnn.named_parameters():
            if name.startswith("bias_hh"):
                with torch.no_grad():
                    p[:2 * hidden_size].zero_()  # flax's cell has no such bias
                p.register_hook(functools.partial(_pin_rz_rows, hidden=hidden_size))
        if att == "self_att":
            self.att_linear1 = nn.Linear(2 * hidden_size, attention_size,
                                         bias=False)
            self.att_linear2 = nn.Linear(attention_size, _N_HEADS, bias=False)
        self.dense1 = nn.Linear(2 * hidden_size, 128)
        if pred in ("emotion", "multitask"):
            self.pred_emotion_layer = nn.Linear(128, NUM_EMO_CLASSES)
        if pred in ("gender", "multitask"):
            self.pred_gender_layer = nn.Linear(128, NUM_GENDER_CLASSES)

    def _dropout(self, x, draws: Optional[DropoutDraws], shape) -> torch.Tensor:
        """flax's Dropout: x / keep where kept, else 0 (identity in eval); keep
        = 1 - rate is rounded to x's dtype first, as JAX rounds the weak-typed
        scalar."""
        if not self.training or self.dropout_rate == 0.0:
            return x
        if draws is None:
            raise ValueError("a train-mode forward with dropout needs DropoutDraws")
        mask = draws.keep(shape, self.dropout_rate)
        keep = torch.tensor(1.0 - self.dropout_rate, dtype=x.dtype).item()
        return torch.where(mask, x / keep, torch.zeros_like(x))

    @staticmethod
    def _update_running(bn: nn.BatchNorm2d, mean, var):
        with torch.no_grad():
            bn.running_mean.copy_(_MOMENTUM * bn.running_mean + (1.0 - _MOMENTUM) * mean)
            bn.running_var.copy_(_MOMENTUM * bn.running_var + (1.0 - _MOMENTUM) * var)
            bn.num_batches_tracked += 1

    def _rnn(self, x, draws):
        """One single-layer BiGRU call per layer, our own masks between.  In
        f32, ``train`` asks cuDNN to keep what its backward needs: in training
        and whenever a gradient flows (the eval-mode cloak backbone); serving
        runs without it.  In bf16 each layer is :func:`bigru_layer_lowp`."""
        rnn = self.rnn
        keep = self.training or torch.is_grad_enabled()
        for layer in range(rnn.num_layers):
            if layer:
                x = self._dropout(x, draws, x.shape)
            weights = [getattr(rnn, f"{kind}_l{layer}{sfx}") for sfx in ("", "_reverse")
                       for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            if self.compute_dtype == torch.float32:
                h0 = x.new_zeros(2, x.shape[0], rnn.hidden_size)
                x = torch._VF.gru(x, h0, weights, True, 1, 0.0, keep, True, True)[0]
            else:
                x = bigru_layer_lowp(x, weights, self.compute_dtype)
        return x

    def _conv_bn(self, x, conv, bn, train: bool, update_stats: bool):
        """Conv + BatchNorm of block 2 or 3.  In f32: ``F.conv2d`` and
        ``F.batch_norm``, the running statistics from the biased variance.
        In bf16, as flax's ``nn.Conv`` and ``nn.BatchNorm`` with that dtype
        (see the module docstring): moments and normalization in f32 ops, so
        that the backward is f32 too (``F.batch_norm`` on a bf16 input gives
        flax's forward but not its f32 backward), the output rounded."""
        cd = self.compute_dtype
        if cd == torch.float32:
            x = tf.conv2d(x, conv.weight, conv.bias, padding=2)
            if not train:
                return tf.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                                     bn.bias, training=False, eps=bn.eps)
            if update_stats:
                with torch.no_grad():
                    var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                self._update_running(bn, mean, var)
            return tf.batch_norm(x, None, None, bn.weight, bn.bias, training=True,
                                 eps=bn.eps)
        x = tf.conv2d(x, conv.weight.to(cd), padding=2) + conv.bias.to(cd)[:, None, None]
        xf = x.float()
        if train:
            mean = xf.mean((0, 2, 3))
            var = torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
            if update_stats:
                self._update_running(bn, mean.detach(), var.detach())
        else:
            mean, var = bn.running_mean, bn.running_var
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return ((xf - mean[:, None, None]) * mul[:, None, None]
                + bn.bias[:, None, None]).to(cd)

    def encode(self, x: torch.Tensor, dropout: Optional[DropoutDraws] = None,
               update_stats: bool = True) -> torch.Tensor:
        """(B, 1, T, D) f32 -> (B, T/8, 2*hidden) f32.  In train mode,
        ``update_stats`` False normalizes with the batch's moments but leaves
        the running statistics as they are."""
        train, cd = self.training, self.compute_dtype
        conv, bn = self.conv[0], self.conv[1]
        if train:
            x, mean, var = block1_train_forward(x, conv.weight, conv.bias, bn.weight,
                                                bn.bias, bn.eps, cd)
            if update_stats:
                self._update_running(bn, mean, var)
        else:
            x = block1_eval(x, conv.weight, conv.bias, bn.weight, bn.bias,
                            bn.running_mean, bn.running_var, bn.eps, cd)
        x = self._dropout(x, dropout, (x.shape[0], x.shape[1], 1, 1))
        for i in range(1, len(_CHANNELS)):
            x = self._conv_bn(x, self.conv[5 * i], self.conv[5 * i + 1], train, update_stats)
            x = tf.max_pool2d(torch.relu(x), 2)
            x = self._dropout(x, dropout, (x.shape[0], x.shape[1], 1, 1))
        return self._rnn(flatten_channel_major(x), dropout)

    def pool(self, x: torch.Tensor, pooling: Optional[str] = "mean"):
        """Temporal pooling: mean, flatten (``pooling=None``), or additive
        multi-head self-attention ``mean_heads(softmax_T(W2 tanh(W1 x)) @ x)``."""
        if self.att is None:
            return x.mean(1) if pooling is not None else x.reshape(x.shape[0], -1)
        att = self.att_linear2(torch.tanh(self.att_linear1(x)))  # (B, T, heads)
        att = torch.softmax(att.transpose(1, 2), dim=-1)
        return (att @ x).mean(1)

    def forward(self, x: torch.Tensor, pooling: Optional[str] = "mean",
                dropout: Optional[DropoutDraws] = None, update_stats: bool = True):
        """(B, 1, T, D) windows -> logits; a tuple (emotion, gender) for
        ``pred="multitask"``.  A train-mode call with a non-zero dropout rate
        needs ``dropout``."""
        z = torch.relu(self.dense1(self.pool(self.encode(x, dropout, update_stats),
                                             pooling)))
        z = self._dropout(z, dropout, z.shape)
        if self.pred == "multitask":
            return self.pred_emotion_layer(z), self.pred_gender_layer(z)
        if self.pred == "emotion":
            return self.pred_emotion_layer(z)
        return self.pred_gender_layer(z)
