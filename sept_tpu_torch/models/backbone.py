"""The model zoo in PyTorch, eval and train mode.

Counterparts of ``sept_tpu/models/backbone.py``:

- ``Conv2dBiRNN`` (``2d-cnn-lstm``, ``cnn-lstm-att``) and its pieces
  (``_conv_block``, ``_FusedBN0``, ``_flatten_channel_major``,
  ``StackedBiRNN``, ``AttentionPool``, ``_Heads``), with a GRU or
  (``rnn_cell="lstm"``) an LSTM;
- ``DeepConv2dBiRNN`` (``deep-2d-cnn-lstm``): a fourth, un-pooled 128 -> 128
  conv block (``conv.15`` conv, ``conv.16`` BatchNorm) and flatten pooling,
  so ``dense1`` takes ``2H * win_len // 8``;
- ``OneDConvNet`` (``1d-cnn-lstm-att``): Conv1d over time with the mel bins
  as channels, 128/256/512 wide, max pool 2/5/5, then a time-major flatten
  or 8-head attention with biases, ``classifier`` and the heads;
- ``PlainConv2d`` (``2d-cnn``): six 3x3 convolutions, BatchNorm and a 2x2
  pool on blocks 1, 3 and 5, channel dropout 0.5, then a per-class
  projection ``w1`` (emotion) or ``w2`` (otherwise) of the time axis and a
  mean over the features.

Layout is NCHW: windows enter as (B, 1, win_len, feature_len).  The 2-D
CNN + RNN family's parameter names are the reference's ``two_d_cnn_lstm``
state_dict keys (``conv.{0,5,10,15}`` conv, ``conv.{1,6,11,16}``
BatchNorm, ``rnn.*`` an ``nn.GRU`` or ``nn.LSTM`` (it holds the weights;
its forward is never called), ``att_linear{1,2}``, ``dense1``,
``pred_emotion_layer`` / ``pred_gender_layer``), so a reference checkpoint
or :mod:`sept_tpu_torch.compat.from_jax` output strict-loads.  The names of
``OneDConvNet`` and ``PlainConv2d`` are listed in
:mod:`sept_tpu_torch.compat.from_jax`.

The first conv block of the 2-D CNN + RNN family runs through the
hand-written CUDA kernels of :mod:`sept_tpu_torch.ops.conv_block1`
(``Block1Train`` / ``Block1Eval``, forward and backward); the later blocks
are ``F.conv2d`` + BatchNorm + ReLU + ``F.max_pool2d`` (the JAX package
leaves them to XLA, outside any Pallas kernel).  ``OneDConvNet`` and
``PlainConv2d`` have no Pallas kernel in the JAX package and none here.

``compute_dtype`` is the JAX model's ``dtype`` knob (the CLIs'
``--compute_dtype``), which only the 2-D CNN + RNN family has:
``torch.float32`` (the default) or ``torch.bfloat16``.  Parameters and
running statistics stay f32 in both.  In bf16, as flax with
``dtype=bfloat16`` and ``conv_backend="fused1"``:

- block 1 runs the kernels' bf16 mode and returns bf16 pooled values; the
  channel dropout after each block is bf16;
- the later blocks convolve in bf16 (input, weight and bias rounded; the
  bias is added to the rounded output), and BatchNorm computes its batch
  moments in f32 from the bf16 input (flax's ``force_float32_reductions``:
  mean and E[x^2] - mean^2, the biased variance, which the running
  statistics take) and the normalization ``(x - mean) * (rsqrt(var + eps) *
  gamma) + beta`` in f32, rounded to bf16;
- the RNN follows ``nn.RNN(nn.GRUCell(dtype=bfloat16))`` or
  ``nn.RNN(nn.OptimizedLSTMCell(dtype=bfloat16))``: the gate Dense layers
  round their inputs, kernels and biases to bf16 and return bf16, the carry
  stays f32 and its update is promoted to f32 (:func:`bigru_layer_lowp`,
  :func:`bilstm_layer_lowp`; cuDNN's bf16 RNNs would keep a bf16 hidden
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
  (B, C, 1, 1) channel mask after each 2-D conv block, an elementwise mask
  after each 1-D conv block, between the RNN layers and after ``dense1`` /
  ``classifier``; the 2-layer BiRNN therefore runs, in every mode, as one
  single-layer call per layer on that layer's own ``rnn.*_l{L}`` weights;
- flax's cells have one bias per gate where torch's have two.  The GRU's
  ``bias_hh[0:2H]`` (the r and z rows) and the whole of the LSTM's
  ``bias_ih`` start at 0 and are pinned there by a gradient hook;
  :mod:`~sept_tpu_torch.compat.from_jax` puts each flax bias wholly in the
  other tensor.  If torch also trained the pinned rows, each gate's bias
  would move at twice the JAX rate, and weight decay would fall on one
  addend and not on the sum.

Sync-BN (the JAX models' ``bn_axis_name``): ``Conv2dBiRNN`` and
``DeepConv2dBiRNN`` built with a data-parallel ``bn_group``
(:class:`sept_tpu_torch.parallel.DataGroup`) normalize every train-mode
BatchNorm with the moments of every rank's rows, as flax's BatchNorm with
``axis_name`` does: block 1 through :class:`~sept_tpu_torch.ops.conv_block1.Block1Train`'s
group, the later blocks with all-reduced sums of x and x^2 (var = E[x^2] -
E[x]^2, in f32 ops in both dtypes; ``F.batch_norm`` cannot take global
moments) through a differentiable all-reduce, so that the backward keeps
its cross-rank terms.  The running statistics take the global moments.
Eval mode needs no collective.

Every model takes ``forward(x, pooling=..., dropout=..., update_stats=...,
global_feature=...)`` so that the train steps, the cloaks and the saliency
term run any of them; ``pooling`` only matters to the 2-D CNN + RNN family
(``OneDConvNet`` and ``PlainConv2d`` ignore it, as in the JAX package).

The global feature (``--global_feature 1``): a model built with
``global_dim=N_GLOBAL`` concatenates the utterance's 88-dim vector
``global_feature`` (B, 88) after pooling, on the f32 pooled vector, so
``dense1`` (``classifier`` for ``OneDConvNet``) takes pooled + 88 inputs;
``PlainConv2d`` accepts both and ignores them, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as tf
from torch import nn

from sept_tpu_torch.ops.conv_block1 import block1_eval, block1_train_forward

__all__ = ["Conv2dBiRNN", "DeepConv2dBiRNN", "OneDConvNet", "PlainConv2d", "DropoutDraws",
           "NUM_EMO_CLASSES", "NUM_GENDER_CLASSES", "N_GLOBAL", "bigru_layer_lowp",
           "bilstm_layer_lowp", "flatten_channel_major"]

NUM_EMO_CLASSES = 4  # neu / hap / sad / ang
NUM_GENDER_CLASSES = 2  # F / M
N_GLOBAL = 88  # the global feature's width (the gemaps functionals)
_CHANNELS = (32, 64, 128)
_N_HEADS = 16
_MOMENTUM = 0.9  # flax convention: ra = 0.9 * ra + 0.1 * batch (torch's 0.1)
_ONE_D = ((128, 2), (256, 5), (512, 5))  # OneDConvNet's (channels, pool) per block
_ONE_D_HEADS = 8
# PlainConv2d's (channels, BatchNorm, pool) per block
_PLAIN = ((32, False, False), (48, True, True), (64, False, False), (64, True, True),
          (64, False, False), (64, True, True))


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


def _pin_rows(grad: torch.Tensor, rows: int) -> torch.Tensor:
    """The gradient with its first ``rows`` rows zeroed."""
    return torch.cat([torch.zeros_like(grad[:rows]), grad[rows:]])


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


def bilstm_layer_lowp(x: torch.Tensor, weights, dtype: torch.dtype) -> torch.Tensor:
    """One bidirectional LSTM layer computed as flax's
    ``OptimizedLSTMCell(dtype=dtype)`` under ``nn.RNN``: (B, T, F) -> (B, T,
    2H) f32.

    ``weights`` as for :func:`bigru_layer_lowp`, gate rows i, f, g, o;
    ``bias_ih`` is 0 (flax's input Dense layers have no bias) and is not
    read.  The input projection (no bias) and the hidden one (its bias added
    after the rounded product) are each rounded to ``dtype``, summed in
    ``dtype``, and the gates' sigmoid and tanh are in ``dtype``; the carry
    (c, h) is f32: ``c' = f * c + i * g`` promotes at ``f * c`` (``i * g``
    is a ``dtype`` product) and ``h' = o * tanh(c')`` takes tanh in f32."""
    hidden = weights[1].shape[1]
    w_ih = torch.stack([weights[0], weights[4]]).to(dtype)          # (2, 4H, F)
    w_hh = torch.stack([weights[1], weights[5]]).to(dtype).transpose(1, 2)  # (2, H, 4H)
    b_hh = torch.stack([weights[3], weights[7]]).to(dtype)[:, None]
    xs = x.to(dtype)
    gi = torch.stack([xs, xs.flip(1)]) @ w_ih.transpose(1, 2)[:, None]  # (2, B, T, 4H)
    h = x.new_zeros((2, x.shape[0], hidden), dtype=torch.float32)
    c = torch.zeros_like(h)
    outs = []
    for t in range(x.shape[1]):
        g = (torch.bmm(h.to(dtype), w_hh) + b_hh) + gi[:, :, t]
        i, f, o = (torch.sigmoid(g[..., k * hidden:(k + 1) * hidden]) for k in (0, 1, 3))
        cand = torch.tanh(g[..., 2 * hidden:3 * hidden])
        c = f * c + i * cand
        h = o * torch.tanh(c)
        outs.append(h)
    out = torch.stack(outs, 2)  # (2, B, T, H)
    return torch.cat([out[0], out[1].flip(1)], -1)


class _Backbone(nn.Module):
    """What every model of the zoo shares: flax's dropout from
    :class:`DropoutDraws`, flax's BatchNorm running statistics, and the task
    head(s) after ``dense1`` / ``classifier``."""

    def _init_heads(self, pred: str, width: int = 128):
        if pred not in ("emotion", "gender", "multitask"):
            raise ValueError(f"unknown pred: {pred!r}")
        self.pred = pred
        if pred in ("emotion", "multitask"):
            self.pred_emotion_layer = nn.Linear(width, NUM_EMO_CLASSES)
        if pred in ("gender", "multitask"):
            self.pred_gender_layer = nn.Linear(width, NUM_GENDER_CLASSES)

    @staticmethod
    def _with_global(z, global_feature):
        """The pooled vector with the global feature concatenated, if any."""
        return z if global_feature is None else torch.cat([z, global_feature], -1)

    def _heads(self, z):
        if self.pred == "multitask":
            return self.pred_emotion_layer(z), self.pred_gender_layer(z)
        if self.pred == "emotion":
            return self.pred_emotion_layer(z)
        return self.pred_gender_layer(z)

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

    def _channel_dropout(self, x, draws):
        return self._dropout(x, draws, (x.shape[0], x.shape[1], 1, 1))

    @staticmethod
    def _update_running(bn: nn.BatchNorm2d, mean, var):
        with torch.no_grad():
            bn.running_mean.copy_(_MOMENTUM * bn.running_mean + (1.0 - _MOMENTUM) * mean)
            bn.running_var.copy_(_MOMENTUM * bn.running_var + (1.0 - _MOMENTUM) * var)
            bn.num_batches_tracked += 1

    def _batch_norm(self, x, bn: nn.BatchNorm2d, train: bool, update_stats: bool):
        """f32 BatchNorm over (B, H, W): running statistics in eval mode; in
        train mode the batch's moments, the running statistics updated from
        the biased variance unless ``update_stats`` is False."""
        if not train:
            return tf.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                 training=False, eps=bn.eps)
        if update_stats:
            with torch.no_grad():
                var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self._update_running(bn, mean, var)
        return tf.batch_norm(x, None, None, bn.weight, bn.bias, training=True, eps=bn.eps)


class Conv2dBiRNN(_Backbone):
    """Three conv blocks (32/64/128 channels, 5x5, BN, ReLU, 2x2 max pool,
    channel dropout), channel-major flatten, 2-layer BiGRU (or BiLSTM), mean
    or 16-head attention pooling, dense 128, task head(s)."""

    def __init__(self, hidden_size: int = 64, feature_len: int = 128,
                 pred: str = "emotion", att: Optional[str] = None,
                 attention_size: int = 128, num_rnn_layers: int = 2,
                 dropout_rate: float = 0.2, compute_dtype: torch.dtype = torch.float32,
                 rnn_cell: str = "gru", global_dim: int = 0, bn_group=None):
        super().__init__()
        if att not in (None, "self_att"):
            raise ValueError(f"unknown att: {att!r}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, "
                             f"got {compute_dtype}")
        if rnn_cell not in ("gru", "lstm"):
            raise ValueError(f"Unsupported RNN cell: {rnn_cell!r}")
        self.att, self.dropout_rate = att, dropout_rate
        self.compute_dtype, self.rnn_cell = compute_dtype, rnn_cell
        self.bn_group = bn_group  # sync-BN over a data-parallel group, or None
        layers = []
        c_in = 1
        for c in _CHANNELS:
            layers += [nn.Conv2d(c_in, c, 5, padding=2), nn.BatchNorm2d(c),
                       nn.ReLU(), nn.MaxPool2d(2), nn.Dropout2d(dropout_rate)]
            c_in = c
        self.conv = nn.Sequential(*layers)
        d_out = feature_len // 2 ** len(_CHANNELS)
        rnn = nn.GRU if rnn_cell == "gru" else nn.LSTM
        self.rnn = rnn(_CHANNELS[-1] * d_out, hidden_size, num_layers=num_rnn_layers,
                       batch_first=True, bidirectional=True, dropout=dropout_rate)
        # flax's cells have one bias a gate: pin torch's second one at 0
        pinned = ("bias_hh", 2 * hidden_size) if rnn_cell == "gru" else \
            ("bias_ih", 4 * hidden_size)
        for name, p in self.rnn.named_parameters():
            if name.startswith(pinned[0]):
                with torch.no_grad():
                    p[:pinned[1]].zero_()
                p.register_hook(functools.partial(_pin_rows, rows=pinned[1]))
        if att == "self_att":
            self.att_linear1 = nn.Linear(2 * hidden_size, attention_size,
                                         bias=False)
            self.att_linear2 = nn.Linear(attention_size, _N_HEADS, bias=False)
        self.dense1 = nn.Linear(2 * hidden_size + global_dim, 128)
        self._init_heads(pred)

    def _rnn(self, x, draws):
        """One single-layer BiRNN call per layer, our own masks between.  In
        f32, ``train`` asks cuDNN to keep what its backward needs: in training
        and whenever a gradient flows (the eval-mode cloak backbone); serving
        runs without it.  In bf16 each layer is :func:`bigru_layer_lowp` or
        :func:`bilstm_layer_lowp`."""
        rnn = self.rnn
        keep = self.training or torch.is_grad_enabled()
        for layer in range(rnn.num_layers):
            if layer:
                x = self._dropout(x, draws, x.shape)
            weights = [getattr(rnn, f"{kind}_l{layer}{sfx}") for sfx in ("", "_reverse")
                       for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
            h0 = x.new_zeros(2, x.shape[0], rnn.hidden_size, dtype=torch.float32)
            if self.compute_dtype != torch.float32:
                lowp = bigru_layer_lowp if self.rnn_cell == "gru" else bilstm_layer_lowp
                x = lowp(x, weights, self.compute_dtype)
            elif self.rnn_cell == "gru":
                x = torch._VF.gru(x, h0, weights, True, 1, 0.0, keep, True, True)[0]
            else:
                x = torch._VF.lstm(x, (h0, h0), weights, True, 1, 0.0, keep, True, True)[0]
        return x

    def _moments(self, xf):
        """Train-mode batch moments (mean, biased var) of f32 ``xf`` over (B,
        H, W), flax's: E[x] and E[x^2] - E[x]^2; over every rank's rows with
        a ``bn_group``."""
        group = self.bn_group
        if group is None:
            mean = xf.mean((0, 2, 3))
            return mean, torch.clamp((xf * xf).mean((0, 2, 3)) - mean * mean, min=0.0)
        n = xf.shape[0] * xf.shape[2] * xf.shape[3] * group.world_size
        sums = group.sum(torch.stack([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))])) / n
        return sums[0], torch.clamp(sums[1] - sums[0] * sums[0], min=0.0)

    def _conv_bn(self, x, conv, bn, train: bool, update_stats: bool):
        """Conv + BatchNorm of a block after the first.  In f32:
        ``F.conv2d`` and :meth:`_batch_norm`.  In bf16, as flax's ``nn.Conv``
        and ``nn.BatchNorm`` with that dtype (see the module docstring):
        moments and normalization in f32 ops, so that the backward is f32 too
        (``F.batch_norm`` on a bf16 input gives flax's forward but not its f32
        backward), the output rounded.  Sync-BN (``bn_group``) in train mode
        takes the f32 ops in both dtypes."""
        cd = self.compute_dtype
        sync = train and self.bn_group is not None
        if cd == torch.float32 and not sync:
            return self._batch_norm(tf.conv2d(x, conv.weight, conv.bias, padding=2), bn,
                                    train, update_stats)
        if cd == torch.float32:
            x = tf.conv2d(x, conv.weight, conv.bias, padding=2)
        else:
            x = tf.conv2d(x, conv.weight.to(cd), padding=2) + conv.bias.to(cd)[:, None, None]
        xf = x.float()
        if train:
            mean, var = self._moments(xf)
            if update_stats:
                self._update_running(bn, mean.detach(), var.detach())
        else:
            mean, var = bn.running_mean, bn.running_var
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return ((xf - mean[:, None, None]) * mul[:, None, None]
                + bn.bias[:, None, None]).to(cd)

    def _n_blocks(self) -> int:
        return len(_CHANNELS)

    def encode(self, x: torch.Tensor, dropout: Optional[DropoutDraws] = None,
               update_stats: bool = True) -> torch.Tensor:
        """(B, 1, T, D) f32 -> (B, T/8, 2*hidden) f32.  In train mode,
        ``update_stats`` False normalizes with the batch's moments but leaves
        the running statistics as they are."""
        train, cd = self.training, self.compute_dtype
        conv, bn = self.conv[0], self.conv[1]
        if train:
            x, mean, var = block1_train_forward(x, conv.weight, conv.bias, bn.weight,
                                                bn.bias, bn.eps, cd, self.bn_group)
            if update_stats:
                self._update_running(bn, mean, var)
        else:
            x = block1_eval(x, conv.weight, conv.bias, bn.weight, bn.bias,
                            bn.running_mean, bn.running_var, bn.eps, cd)
        x = self._channel_dropout(x, dropout)
        for i in range(1, self._n_blocks()):
            x = torch.relu(self._conv_bn(x, self.conv[5 * i], self.conv[5 * i + 1], train,
                                         update_stats))
            if i < len(_CHANNELS):  # the deep model's fourth block does not pool
                x = tf.max_pool2d(x, 2)
            x = self._channel_dropout(x, dropout)
        return self._rnn(flatten_channel_major(x), dropout)

    def pool(self, x: torch.Tensor, pooling: Optional[str] = "mean"):
        """Temporal pooling: mean, flatten (``pooling=None``), or additive
        multi-head self-attention ``mean_heads(softmax_T(W2 tanh(W1 x)) @ x)``."""
        if self.att is None:
            return x.mean(1) if pooling is not None else x.reshape(x.shape[0], -1)
        return _attention_pool(x, self.att_linear1, self.att_linear2)

    def forward(self, x: torch.Tensor, pooling: Optional[str] = "mean",
                dropout: Optional[DropoutDraws] = None, update_stats: bool = True,
                global_feature: Optional[torch.Tensor] = None):
        """(B, 1, T, D) windows [and (B, 88) global vectors] -> logits; a
        tuple (emotion, gender) for ``pred="multitask"``.  A train-mode call
        with a non-zero dropout rate needs ``dropout``."""
        z = self.pool(self.encode(x, dropout, update_stats), pooling)
        z = torch.relu(self.dense1(self._with_global(z, global_feature)))
        return self._heads(self._dropout(z, dropout, z.shape))


class DeepConv2dBiRNN(Conv2dBiRNN):
    """Conv2dBiRNN with a fourth, un-pooled 128 -> 128 conv block (``conv.15``
    conv, ``conv.16`` BatchNorm, ReLU, channel dropout) before the flatten.
    Without attention it pools by flattening the RNN sequence
    (``pooling=None``, :func:`sept_tpu_torch.models.pooling_for`), so
    ``dense1`` takes ``2 * hidden_size * (win_len // 8)``: a function of the
    window length it is trained on.  Block 1 is Conv2dBiRNN's, in the same
    kernels."""

    def __init__(self, hidden_size: int = 64, feature_len: int = 128, win_len: int = 200,
                 pred: str = "emotion", att: Optional[str] = None,
                 attention_size: int = 128, num_rnn_layers: int = 2,
                 dropout_rate: float = 0.2, compute_dtype: torch.dtype = torch.float32,
                 rnn_cell: str = "gru", global_dim: int = 0, bn_group=None):
        super().__init__(hidden_size, feature_len, pred, att, attention_size, num_rnn_layers,
                         dropout_rate, compute_dtype, rnn_cell, global_dim, bn_group)
        c = _CHANNELS[-1]
        self.conv.extend([nn.Conv2d(c, c, 5, padding=2), nn.BatchNorm2d(c), nn.ReLU(),
                          nn.Dropout2d(dropout_rate)])
        if att is None:
            self.dense1 = nn.Linear(
                2 * hidden_size * (win_len // 2 ** len(_CHANNELS)) + global_dim, 128)

    def _n_blocks(self) -> int:
        return len(_CHANNELS) + 1

    def forward(self, x: torch.Tensor, pooling: Optional[str] = None,
                dropout: Optional[DropoutDraws] = None, update_stats: bool = True,
                global_feature: Optional[torch.Tensor] = None):
        return super().forward(x, pooling, dropout, update_stats, global_feature)


def _attention_pool(x, linear1, linear2):
    att = linear2(torch.tanh(linear1(x)))  # (B, T, heads)
    att = torch.softmax(att.transpose(1, 2), dim=-1)
    return (att @ x).mean(1)


class OneDConvNet(_Backbone):
    """Conv1d over time with the ``feature_len`` mel bins as input channels:
    three blocks of conv (width 5, SAME) + ReLU + max pool (2, 5, 5) +
    elementwise dropout, 128/256/512 channels (``Conv_0`` .. ``Conv_2``);
    then a time-major flatten (flax's (B, T, C) order: 512 *
    (win_len // 50) wide) or 8-head attention with biases
    (``att_linear{1,2}``); ``classifier`` (dense 128 + ReLU + dropout) and the
    head(s)."""

    def __init__(self, feature_len: int = 128, win_len: int = 200, pred: str = "emotion",
                 att: Optional[str] = None, attention_size: int = 128,
                 dropout_rate: float = 0.2, global_dim: int = 0):
        super().__init__()
        if att not in (None, "self_att"):
            raise ValueError(f"unknown att: {att!r}")
        self.att, self.dropout_rate = att, dropout_rate
        c_in, t = feature_len, win_len
        for i, (c, pool) in enumerate(_ONE_D):
            setattr(self, f"Conv_{i}", nn.Conv1d(c_in, c, 5, padding=2))
            c_in, t = c, t // pool
        if att == "self_att":
            self.att_linear1 = nn.Linear(c_in, attention_size)
            self.att_linear2 = nn.Linear(attention_size, _ONE_D_HEADS)
        self.classifier = nn.Linear(c_in * (t if att is None else 1) + global_dim, 128)
        self._init_heads(pred)

    def forward(self, x: torch.Tensor, pooling: Optional[str] = None,
                dropout: Optional[DropoutDraws] = None, update_stats: bool = True,
                global_feature: Optional[torch.Tensor] = None):
        """(B, 1, T, D) windows [and (B, 88) global vectors] -> logits;
        ``pooling`` and ``update_stats`` are accepted for the shared call and
        unused."""
        x = x[:, 0].transpose(1, 2)  # (B, D, T): the mel bins are the channels
        for i, (_, pool) in enumerate(_ONE_D):
            x = tf.max_pool1d(torch.relu(getattr(self, f"Conv_{i}")(x)), pool)
            x = self._dropout(x, dropout, x.shape)
        x = x.transpose(1, 2)  # (B, T', C)
        if self.att is None:
            z = x.reshape(x.shape[0], -1)
        else:
            z = _attention_pool(x, self.att_linear1, self.att_linear2)
        z = torch.relu(self.classifier(self._with_global(z, global_feature)))
        return self._heads(self._dropout(z, dropout, z.shape))


class PlainConv2d(_Backbone):
    """Six 3x3 SAME convolutions (``conv0`` .. ``conv5``: 32, 48, 64, 64, 64,
    64 channels), BatchNorm (``bn1``, ``bn3``, ``bn5``) then a 2x2 max pool
    on blocks 1, 3 and 5, ReLU and channel dropout (rate 0.5) on each; then
    the channel-major flatten, turned to (B, F, win_len // 8), times the
    per-class projection ``w1`` (emotion) or ``w2`` (any other ``pred``: 2
    classes) of shape (win_len // 8, classes), and the mean over F."""

    def __init__(self, win_len: int = 200, pred: str = "emotion", dropout_rate: float = 0.5,
                 global_dim: int = 0):
        super().__init__()
        if pred not in ("emotion", "gender", "multitask"):
            raise ValueError(f"unknown pred: {pred!r}")
        self.pred, self.dropout_rate = pred, dropout_rate
        c_in = 1
        for i, (c, bn, _) in enumerate(_PLAIN):
            setattr(self, f"conv{i}", nn.Conv2d(c_in, c, 3, padding=1))
            if bn:
                setattr(self, f"bn{i}", nn.BatchNorm2d(c))
            c_in = c
        n_out = NUM_EMO_CLASSES if pred == "emotion" else NUM_GENDER_CLASSES
        # flax's uniform(1.0): U[0, 1)
        w = nn.Parameter(torch.rand(win_len // 8, n_out))
        setattr(self, "w1" if pred == "emotion" else "w2", w)

    def forward(self, x: torch.Tensor, pooling: Optional[str] = None,
                dropout: Optional[DropoutDraws] = None, update_stats: bool = True,
                global_feature: Optional[torch.Tensor] = None):
        """(B, 1, T, D) windows -> (B, classes) logits; ``pooling``,
        ``global_dim`` and ``global_feature`` are accepted for the shared
        call and unused, as in the JAX package."""
        for i, (_, bn, pool) in enumerate(_PLAIN):
            x = getattr(self, f"conv{i}")(x)
            if bn:
                x = self._batch_norm(x, getattr(self, f"bn{i}"), self.training, update_stats)
            x = torch.relu(x)
            if pool:
                x = tf.max_pool2d(x, 2)
            x = self._channel_dropout(x, dropout)
        x = flatten_channel_major(x).transpose(1, 2)  # (B, F, T/8)
        w = self.w1 if self.pred == "emotion" else self.w2
        return (x @ w).mean(1)
