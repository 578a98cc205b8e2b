"""Conv2dBiRNN in PyTorch, eval forward (the serving path).

Counterpart of ``sept_tpu/models/backbone.py::Conv2dBiRNN`` and its pieces
(``_conv_block``, ``_flatten_channel_major``, ``StackedBiRNN``,
``AttentionPool``, ``_Heads``).  Layout is NCHW: windows enter as
(B, 1, win_len, feature_len).  Parameter names are the reference's
``two_d_cnn_lstm`` state_dict keys (``conv.{0,5,10}`` conv, ``conv.{1,6,11}``
BatchNorm, ``rnn.*`` an ``nn.GRU``, ``att_linear{1,2}``, ``dense1``,
``pred_emotion_layer`` / ``pred_gender_layer``), so a reference checkpoint or
:mod:`sept_tpu_torch.compat.from_jax` output strict-loads.

The first conv block runs through the hand-written CUDA kernels of
:mod:`sept_tpu_torch.ops.conv_block1`; blocks 2-3 are ``F.conv2d`` +
``F.batch_norm`` + ReLU + ``F.max_pool2d`` (the JAX package leaves them to
XLA, outside any Pallas kernel).  Only the eval forward is ported: dropout
is the identity and BatchNorm uses its running statistics.  Training is the
next slice, and ``forward`` refuses train mode until then.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as tf
from torch import nn

from sept_tpu_torch.ops.conv_block1 import block1_eval

__all__ = ["Conv2dBiRNN", "NUM_EMO_CLASSES", "NUM_GENDER_CLASSES",
           "flatten_channel_major"]

NUM_EMO_CLASSES = 4  # neu / hap / sad / ang
NUM_GENDER_CLASSES = 2  # F / M
_CHANNELS = (32, 64, 128)
_N_HEADS = 16


def flatten_channel_major(x: torch.Tensor) -> torch.Tensor:
    """(B, C, T', D') -> (B, T', C*D'), channel-major (the reference's
    ``transpose(1, 2).reshape``)."""
    b, c, t, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, t, c * d)


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
        self.pred, self.att = pred, att
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
        if att == "self_att":
            self.att_linear1 = nn.Linear(2 * hidden_size, attention_size,
                                         bias=False)
            self.att_linear2 = nn.Linear(attention_size, _N_HEADS, bias=False)
        self.dense1 = nn.Linear(2 * hidden_size, 128)
        if pred in ("emotion", "multitask"):
            self.pred_emotion_layer = nn.Linear(128, NUM_EMO_CLASSES)
        if pred in ("gender", "multitask"):
            self.pred_gender_layer = nn.Linear(128, NUM_GENDER_CLASSES)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, T, D) -> (B, T/8, 2*hidden)."""
        conv, bn = self.conv[0], self.conv[1]
        x = block1_eval(x, conv.weight, conv.bias, bn.weight, bn.bias,
                        bn.running_mean, bn.running_var, bn.eps)
        for i in range(1, len(_CHANNELS)):
            conv, bn = self.conv[5 * i], self.conv[5 * i + 1]
            x = tf.conv2d(x, conv.weight, conv.bias, padding=2)
            x = tf.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                              bn.bias, training=False, eps=bn.eps)
            x = tf.max_pool2d(torch.relu(x), 2)
        x, _ = self.rnn(flatten_channel_major(x))
        return x

    def pool(self, x: torch.Tensor, pooling: Optional[str] = "mean"):
        """Temporal pooling: mean, flatten (``pooling=None``), or additive
        multi-head self-attention ``mean_heads(softmax_T(W2 tanh(W1 x)) @ x)``."""
        if self.att is None:
            return x.mean(1) if pooling is not None else x.reshape(x.shape[0], -1)
        att = self.att_linear2(torch.tanh(self.att_linear1(x)))  # (B, T, heads)
        att = torch.softmax(att.transpose(1, 2), dim=-1)
        return (att @ x).mean(1)

    def forward(self, x: torch.Tensor, pooling: Optional[str] = "mean"):
        """(B, 1, T, D) windows -> logits; a tuple (emotion, gender) for
        ``pred="multitask"``."""
        if self.training:
            raise NotImplementedError(
                "Conv2dBiRNN is ported for eval only; call .eval() (training "
                "is queued in ROADMAP.md)")
        z = torch.relu(self.dense1(self.pool(self.encode(x), pooling)))
        if self.pred == "multitask":
            return self.pred_emotion_layer(z), self.pred_gender_layer(z)
        if self.pred == "emotion":
            return self.pred_emotion_layer(z)
        return self.pred_gender_layer(z)
