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
forward and backward); blocks 2-3 are ``F.conv2d`` + ``F.batch_norm`` + ReLU
+ ``F.max_pool2d`` (the JAX package leaves them to XLA, outside any Pallas
kernel).

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
           "flatten_channel_major"]

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


class Conv2dBiRNN(nn.Module):
    """Three conv blocks (32/64/128 channels, 5x5, BN, ReLU, 2x2 max pool,
    channel dropout), channel-major flatten, 2-layer BiGRU, mean or 16-head
    attention pooling, dense 128, task head(s)."""

    def __init__(self, hidden_size: int = 64, feature_len: int = 128,
                 pred: str = "emotion", att: Optional[str] = None,
                 attention_size: int = 128, num_rnn_layers: int = 2,
                 dropout_rate: float = 0.2):
        super().__init__()
        if pred not in ("emotion", "gender", "multitask"):
            raise ValueError(f"unknown pred: {pred!r}")
        if att not in (None, "self_att"):
            raise ValueError(f"unknown att: {att!r}")
        self.pred, self.att, self.dropout_rate = pred, att, dropout_rate
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
        """flax's Dropout: x / keep where kept, else 0 (identity in eval)."""
        if not self.training or self.dropout_rate == 0.0:
            return x
        if draws is None:
            raise ValueError("a train-mode forward with dropout needs DropoutDraws")
        keep = draws.keep(shape, self.dropout_rate)
        return torch.where(keep, x / (1.0 - self.dropout_rate), torch.zeros_like(x))

    @staticmethod
    def _update_running(bn: nn.BatchNorm2d, mean, var):
        with torch.no_grad():
            bn.running_mean.copy_(_MOMENTUM * bn.running_mean + (1.0 - _MOMENTUM) * mean)
            bn.running_var.copy_(_MOMENTUM * bn.running_var + (1.0 - _MOMENTUM) * var)
            bn.num_batches_tracked += 1

    def _rnn(self, x, draws):
        """One single-layer BiGRU call per layer, our own masks between.
        ``train`` asks cuDNN to keep what its backward needs: in training and
        whenever a gradient flows (the eval-mode cloak backbone); serving
        runs without it."""
        rnn = self.rnn
        keep = self.training or torch.is_grad_enabled()
        for layer in range(rnn.num_layers):
            if layer:
                x = self._dropout(x, draws, x.shape)
            weights = [getattr(rnn, f"{kind}_l{layer}{sfx}") for sfx in ("", "_reverse")
                       for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            h0 = x.new_zeros(2, x.shape[0], rnn.hidden_size)
            x = torch._VF.gru(x, h0, weights, True, 1, 0.0, keep, True, True)[0]
        return x

    def encode(self, x: torch.Tensor, dropout: Optional[DropoutDraws] = None,
               update_stats: bool = True) -> torch.Tensor:
        """(B, 1, T, D) -> (B, T/8, 2*hidden).  In train mode, ``update_stats``
        False normalizes with the batch's moments but leaves the running
        statistics as they are."""
        train = self.training
        conv, bn = self.conv[0], self.conv[1]
        if train:
            x, mean, var = block1_train_forward(x, conv.weight, conv.bias, bn.weight,
                                                bn.bias, bn.eps)
            if update_stats:
                self._update_running(bn, mean, var)
        else:
            x = block1_eval(x, conv.weight, conv.bias, bn.weight, bn.bias,
                            bn.running_mean, bn.running_var, bn.eps)
        x = self._dropout(x, dropout, (x.shape[0], x.shape[1], 1, 1))
        for i in range(1, len(_CHANNELS)):
            conv, bn = self.conv[5 * i], self.conv[5 * i + 1]
            x = tf.conv2d(x, conv.weight, conv.bias, padding=2)
            if train:
                if update_stats:
                    with torch.no_grad():
                        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
                    self._update_running(bn, mean, var)
                x = tf.batch_norm(x, None, None, bn.weight, bn.bias, training=True,
                                  eps=bn.eps)
            else:
                x = tf.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                                  bn.bias, training=False, eps=bn.eps)
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
