"""WavLM-Large as a backbone of the port: a waveform encoder with WavLM's
gated relative position bias, and the sequence-classification head.

Chen et al., "WavLM: Large-Scale Self-Supervised Pre-Training for Full Stack
Speech Processing" (IEEE JSTSP 2022, arXiv:2110.13900), at the widths of the
``microsoft/wavlm-large`` release (``do_stable_layer_norm``,
``feat_extract_norm="layer"``).  Parameter names are those of Hugging Face's
``WavLMForSequenceClassification`` (``wavlm.feature_extractor...``,
``wavlm.encoder.layers.{i}.attention...``, ``projector``, ``classifier``),
the positional convolution's weight norm as ``weight_g`` / ``weight_v``.

The layers, on a (B, L) wave:

- feature encoder: 7 x [Conv1d -> LayerNorm over the channels -> GELU]
  (``conv_dim``, ``conv_kernel``, ``conv_stride``); a 32,000-sample window
  gives 99 frames;
- feature projection: LayerNorm -> Linear(conv_dim[-1] -> hidden) ->
  dropout (``feat_proj_dropout``);
- positional convolution: ``x += GELU(Conv1d(hidden, hidden,
  k=num_conv_pos_embeddings, pad=k // 2, groups=num_conv_pos_embedding_groups)
  (x))``, the last frame dropped for an even k; the weight is ``weight_g *
  weight_v / ||weight_v||`` with the norm over all dims but the kernel's;
  then dropout (``hidden_dropout``);
- ``num_hidden_layers`` pre-LN layers: ``h = x + drop(Attn(LN1(x)))``,
  ``x' = h + drop(W2 drop_act(GELU(W1 LN2(h))))``; a final LayerNorm;
- attention: ``softmax(q k^T / sqrt(head_dim) + gate[b, h, i] *
  pos_bias[h, i, j])``, then dropout on the probabilities
  (``attention_dropout``).  Layer 0 alone owns ``rel_attn_embed``
  (``num_buckets`` x heads) and builds ``pos_bias`` from T5-style
  bidirectional buckets (:func:`relative_position_bucket`); every layer
  reuses it ungated.  Each layer gates it per head and query from its own
  LN1 output ``u`` split into heads: ``g = sigmoid(sum over pairs of
  Linear(head_dim -> 8)(u))`` gives ``gate_a``, ``gate_b`` and ``gate =
  gate_a * (gate_b * c_h - 1) + 2`` with a learned ``c_h`` a head;
- head: ``projector`` Linear(hidden -> classifier_proj_size) -> the mean
  over frames -> ``classifier``.

LayerDrop and SpecAugment are left out: a layer skipped at random makes the
step depend on the draw, which a CUDA graph cannot replay, and the cloak's
noise is the input perturbation of the games this backbone trains in.

Input: the port's (B, 1, win_len, hop) windows of a wave (``device_ingest``'s
``"wave"`` frontend), read as (B, win_len * hop) samples.

The convolutions run as products of unfolded frames (cuBLAS), frames by
channels throughout, so that no LayerNorm needs a transpose; the grouped
positional convolution has a backward of its own (:class:`_GroupedConv`).
On an H100 at batch 32, cuDNN's bf16 kernels took 126 ms for that
convolution's forward and backward in one backbone, these products 5.5.

``compute_dtype`` ``torch.bfloat16`` is the port's bf16 class: the operands
of every matrix product and convolution are rounded to bf16 and their
outputs (summed in f32, the bias added; the positional convolution's bias
is added in f32 after) stored in bf16; parameters stay f32; the residual
stream, every LayerNorm, GELU, the softmax, the position bias and its gate
are f32, and a value goes to bf16 only as an operand of the next product.  ``projector`` and ``classifier`` are f32.  In
``torch.float32`` everything is f32 (TF32 is off in the steps).

The attention core, from the QKV product's (B, T, 3 hidden) output to the
context (scores, the gated bias, softmax, dropout, P v), is
:func:`~sept_tpu_torch.ops.attention.gated_bias_attention` in bf16: on a
card one kernel forward and one backward (``csrc/attention.cu``) that read
q, k and v where the product left them and keep the scores on chip; on the
CPU its plain version, the composition of torch ops it replaced.  In f32 that
composition runs as it is (``gated_bias_attention_plain``).

Train mode draws every dropout mask from the :class:`DropoutDraws` passed as
``dropout``, in this order: the feature projection's (B, T, hidden), the
positional embedding's (B, T, hidden), then in each layer the attention
probabilities' (B, heads, T, T), the attention output's (B, T, hidden), the
FFN's activation (B, T, intermediate; none at ``activation_dropout`` 0) and
the FFN output's (B, T, hidden).  A kept entry is divided by ``1 - rate``.

In a ``torch.profiler`` session the forward opens ``wavlm.feature_encoder``
around the convolutions and the projection, and in each layer
``wavlm.attention`` (LN1, the gate, the bias and the attention with its
output projection) and ``wavlm.ffn`` (LN2 and the FFN).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as tf
from torch import nn

from sept_tpu_torch.models.backbone import NUM_EMO_CLASSES, NUM_GENDER_CLASSES, DropoutDraws
from sept_tpu_torch.ops.attention import gated_bias_attention, gated_bias_attention_plain
from sept_tpu_torch.utils.profiling import span

__all__ = ["WavLM", "relative_position_bucket"]

_GATE_WIDTH = 8  # gru_rel_pos_linear's outputs: 2 gates x 4 summed


def relative_position_bucket(rel: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5-style bidirectional buckets of relative positions ``rel`` (key
    minus query), as WavLM computes them: half the buckets a direction
    (positive distances offset by ``num_buckets // 2``), distances below a
    quarter of ``num_buckets`` exact, larger ones log-spaced up to
    ``max_distance`` and clamped to the direction's last bucket."""
    half = num_buckets // 2
    out = (rel > 0).to(torch.long) * half
    rel = rel.abs()
    exact = half // 2
    large = torch.log(rel.float() / exact)
    large = large / math.log(max_distance / exact)
    large = (exact + large * (half - exact)).to(torch.long)
    large = torch.clamp(large, max=half - 1)
    return out + torch.where(rel < exact, rel, large)


def _keep_mask(draws: Optional[DropoutDraws], shape, rate: float, training: bool,
               dtype: torch.dtype = torch.float32):
    """A dropout's keep-mask over ``shape`` from ``draws`` and its keep factor
    1 - rate (in ``dtype``), or ``(None, 1.0)`` where nothing is dropped."""
    if not training or rate == 0.0:
        return None, 1.0
    if draws is None:
        raise ValueError("a train-mode forward with dropout needs DropoutDraws")
    return draws.keep(shape, rate), torch.tensor(1.0 - rate, dtype=dtype).item()


def _drop(x: torch.Tensor, draws: Optional[DropoutDraws], rate: float, training: bool):
    """Dropout of ``x`` with a mask from ``draws``: x / (1 - rate) where kept."""
    mask, keep = _keep_mask(draws, x.shape, rate, training, x.dtype)
    if mask is None:
        return x
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _linear(x: torch.Tensor, lin: nn.Linear, cd: torch.dtype) -> torch.Tensor:
    """``lin`` on ``x`` with the weight and bias rounded to ``cd``."""
    return tf.linear(x.to(cd), lin.weight.to(cd), lin.bias.to(cd))


def _conv_frames(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 stride: int, cd: torch.dtype) -> torch.Tensor:
    """A Conv1d over (B, T, C_in) frames, no padding, as one product of the
    unfolded frames (k * C_in wide, a view where the kernel equals the
    stride) with the (C_out, k * C_in) weight: (B, T', C_out) in ``cd``."""
    c_out, c_in, k = weight.shape
    cols = x.to(cd).unfold(1, k, stride).transpose(-1, -2)  # (B, T', k, C_in)
    cols = cols.reshape(x.shape[0], cols.shape[1], k * c_in)
    w = weight.to(cd).transpose(1, 2).reshape(c_out, k * c_in)
    return tf.linear(cols, w, None if bias is None else bias.to(cd))


def _grouped_cols(x: torch.Tensor, k: int, groups: int, pad: int) -> torch.Tensor:
    """(B, T, C) frames, ``pad`` zeros on each side -> each group's unfolded
    frames, (groups, B * T', k * C // groups) with T' = T + 2 pad - k + 1."""
    b, _, c = x.shape
    cols = tf.pad(x, (0, 0, pad, pad)).unfold(1, k, 1)  # (B, T', C, k)
    n = cols.shape[1]
    return cols.view(b, n, groups, c // groups, k).permute(2, 0, 1, 4, 3).reshape(
        groups, b * n, k * c // groups)


def _grouped_weight(w: torch.Tensor, groups: int) -> torch.Tensor:
    """(C_out, C_in / groups, k) -> (groups, k * C_in / groups, C_out / groups),
    rows in :func:`_grouped_cols`' order."""
    c_out, cg, k = w.shape
    return w.view(groups, c_out // groups, cg, k).permute(0, 3, 2, 1).reshape(
        groups, k * cg, c_out // groups)


def _grouped_product(cols: torch.Tensor, w: torch.Tensor, b: int) -> torch.Tensor:
    """The groups' products of :func:`_grouped_cols` and :func:`_grouped_weight`,
    (B, T', C_out)."""
    g, m, cg = cols.shape[0], cols.shape[1], w.shape[-1]
    return torch.bmm(cols, w).view(g, b, m // b, cg).permute(1, 2, 0, 3).reshape(
        b, m // b, g * cg)


class _GroupedConv(torch.autograd.Function):
    """A grouped Conv1d over (B, T, C) frames with ``pad`` zeros on each side
    and no bias, as batched products of unfolded frames, forward and
    backward: the input gradient is the same product of the output
    gradient's frames (padded k - 1 - pad) with the kernel flipped and each
    group's channels swapped; the weight gradient, where one is needed, that
    of the input's frames with the output gradient.  Only the input and the
    weight are kept for the backward."""

    @staticmethod
    def forward(ctx, x, w, groups: int, pad: int):
        ctx.save_for_backward(x, w)
        ctx.groups, ctx.pad = groups, pad
        k = w.shape[-1]
        return _grouped_product(_grouped_cols(x, k, groups, pad), _grouped_weight(w, groups),
                                x.shape[0])

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        g, pad = ctx.groups, ctx.pad
        c_out, cg, k = w.shape
        gx = gw = None
        if ctx.needs_input_grad[0]:
            flipped = w.view(g, c_out // g, cg, k).transpose(1, 2).flip(-1).reshape(
                g * cg, c_out // g, k)
            gx = _grouped_product(_grouped_cols(gy, k, g, k - 1 - pad),
                                  _grouped_weight(flipped, g), x.shape[0])
        if ctx.needs_input_grad[1]:
            cols = _grouped_cols(x, k, g, pad)  # (G, B * T', k * cg)
            gyg = gy.reshape(-1, g, c_out // g).transpose(0, 1)  # (G, B * T', c_out / G)
            gw = torch.bmm(cols.transpose(1, 2), gyg).view(g, k, cg, c_out // g).permute(
                0, 3, 2, 1).reshape(c_out, cg, k)
        return gx, gw, None, None


class _ConvLayer(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel: int, stride: int, bias: bool, eps: float):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, kernel, stride=stride, bias=bias)
        self.layer_norm = nn.LayerNorm(c_out, eps=eps)


class _FeatureExtractor(nn.Module):
    def __init__(self, conv_dim, conv_kernel, conv_stride, conv_bias: bool, eps: float):
        super().__init__()
        c_in, layers = 1, []
        for c, k, s in zip(conv_dim, conv_kernel, conv_stride):
            layers.append(_ConvLayer(c_in, c, k, s, conv_bias, eps))
            c_in = c
        self.conv_layers = nn.ModuleList(layers)


class _FeatureProjection(nn.Module):
    def __init__(self, c_in: int, hidden: int, eps: float):
        super().__init__()
        self.layer_norm = nn.LayerNorm(c_in, eps=eps)
        self.projection = nn.Linear(c_in, hidden)


class _WeightNormConv(nn.Module):
    """A grouped Conv1d's parameters under weight norm over dim 2."""

    def __init__(self, hidden: int, kernel: int, groups: int):
        super().__init__()
        self.groups = groups
        self.weight_g = nn.Parameter(torch.ones(1, 1, kernel))
        self.weight_v = nn.Parameter(torch.empty(hidden, hidden // groups, kernel))
        self.bias = nn.Parameter(torch.zeros(hidden))
        nn.init.normal_(self.weight_v, std=1.0 / math.sqrt(kernel * hidden // groups))
        with torch.no_grad():  # the weight starts as weight_v, as weight norm's init
            self.weight_g.copy_(self._norm())

    def _norm(self) -> torch.Tensor:
        return self.weight_v.pow(2).sum((0, 1), keepdim=True).sqrt()

    def weight(self) -> torch.Tensor:
        return self.weight_g * self.weight_v / self._norm()


class _PosConv(nn.Module):
    def __init__(self, hidden: int, kernel: int, groups: int):
        super().__init__()
        self.conv = _WeightNormConv(hidden, kernel, groups)


class _Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, num_buckets: int, has_bias: bool):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(hidden, hidden)
        self.k_proj = nn.Linear(hidden, hidden)
        self.v_proj = nn.Linear(hidden, hidden)
        self.out_proj = nn.Linear(hidden, hidden)
        self.gru_rel_pos_const = nn.Parameter(torch.ones(1, heads, 1, 1))
        self.gru_rel_pos_linear = nn.Linear(hidden // heads, _GATE_WIDTH)
        if has_bias:
            self.rel_attn_embed = nn.Embedding(num_buckets, heads)


class _FeedForward(nn.Module):
    def __init__(self, hidden: int, intermediate: int):
        super().__init__()
        self.intermediate_dense = nn.Linear(hidden, intermediate)
        self.output_dense = nn.Linear(intermediate, hidden)


class _Layer(nn.Module):
    def __init__(self, hidden, heads, intermediate, num_buckets, has_bias, eps):
        super().__init__()
        self.attention = _Attention(hidden, heads, num_buckets, has_bias)
        self.layer_norm = nn.LayerNorm(hidden, eps=eps)
        self.feed_forward = _FeedForward(hidden, intermediate)
        self.final_layer_norm = nn.LayerNorm(hidden, eps=eps)


class _Encoder(nn.Module):
    def __init__(self, hidden, layers, heads, intermediate, pos_kernel, pos_groups,
                 num_buckets, eps):
        super().__init__()
        self.pos_conv_embed = _PosConv(hidden, pos_kernel, pos_groups)
        self.layer_norm = nn.LayerNorm(hidden, eps=eps)
        self.layers = nn.ModuleList(
            _Layer(hidden, heads, intermediate, num_buckets, i == 0, eps) for i in range(layers))


class _WavLMModel(nn.Module):
    def __init__(self, conv_dim, conv_kernel, conv_stride, conv_bias, hidden, layers, heads,
                 intermediate, pos_kernel, pos_groups, num_buckets, eps):
        super().__init__()
        self.feature_extractor = _FeatureExtractor(conv_dim, conv_kernel, conv_stride,
                                                   conv_bias, eps)
        self.feature_projection = _FeatureProjection(conv_dim[-1], hidden, eps)
        self.encoder = _Encoder(hidden, layers, heads, intermediate, pos_kernel, pos_groups,
                                num_buckets, eps)


class WavLM(nn.Module):
    """WavLM-Large (``wavlm-large``): (B, 1, win_len, hop) wave windows ->
    (B, classes) logits of ``pred``.  Defaults are the published widths."""

    def __init__(self, pred: str = "emotion", hidden_size: int = 1024,
                 num_hidden_layers: int = 24, num_attention_heads: int = 16,
                 intermediate_size: int = 4096, conv_dim: Sequence[int] = (512,) * 7,
                 conv_kernel: Sequence[int] = (10, 3, 3, 3, 3, 2, 2),
                 conv_stride: Sequence[int] = (5, 2, 2, 2, 2, 2, 2), conv_bias: bool = False,
                 num_conv_pos_embeddings: int = 128, num_conv_pos_embedding_groups: int = 16,
                 num_buckets: int = 320, max_bucket_distance: int = 800,
                 layer_norm_eps: float = 1e-5, classifier_proj_size: int = 256,
                 hidden_dropout: float = 0.1, attention_dropout: float = 0.1,
                 activation_dropout: float = 0.0, feat_proj_dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if pred not in ("emotion", "gender"):
            raise ValueError(f"unknown pred: {pred!r}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, "
                             f"got {compute_dtype}")
        if not len(conv_dim) == len(conv_kernel) == len(conv_stride):
            raise ValueError("conv_dim, conv_kernel and conv_stride differ in length")
        if hidden_size % num_attention_heads:
            raise ValueError("hidden_size is not a multiple of num_attention_heads")
        self.pred, self.compute_dtype = pred, compute_dtype
        self.heads = num_attention_heads
        self.num_buckets, self.max_bucket_distance = num_buckets, max_bucket_distance
        self.hidden_dropout, self.attention_dropout = hidden_dropout, attention_dropout
        self.activation_dropout, self.feat_proj_dropout = activation_dropout, feat_proj_dropout
        self.conv_stride = tuple(conv_stride)
        self.wavlm = _WavLMModel(tuple(conv_dim), tuple(conv_kernel), self.conv_stride,
                                 conv_bias, hidden_size, num_hidden_layers, num_attention_heads,
                                 intermediate_size, num_conv_pos_embeddings,
                                 num_conv_pos_embedding_groups, num_buckets, layer_norm_eps)
        self.projector = nn.Linear(hidden_size, classifier_proj_size)
        n_cls = NUM_EMO_CLASSES if pred == "emotion" else NUM_GENDER_CLASSES
        self.classifier = nn.Linear(classifier_proj_size, n_cls)

    # -- the forward, layer by layer -------------------------------------------

    def _features(self, wave: torch.Tensor, draws) -> torch.Tensor:
        """(B, L) f32 wave -> (B, T, hidden) f32 projected frames."""
        cd = self.compute_dtype
        x = wave[..., None]  # (B, L, 1): frames by channels throughout
        layers = self.wavlm.feature_extractor.conv_layers
        for layer, stride in zip(layers, self.conv_stride):
            y = _conv_frames(x, layer.conv.weight, layer.conv.bias, stride, cd)
            ln = layer.layer_norm
            x = tf.gelu(tf.layer_norm(y.float(), ln.normalized_shape, ln.weight, ln.bias,
                                      ln.eps))
        proj = self.wavlm.feature_projection
        x = tf.layer_norm(x, proj.layer_norm.normalized_shape, proj.layer_norm.weight,
                          proj.layer_norm.bias, proj.layer_norm.eps)
        x = _linear(x, proj.projection, cd).float()
        return _drop(x, draws, self.feat_proj_dropout, self.training)

    def _pos_embed(self, x: torch.Tensor) -> torch.Tensor:
        """The positional convolution's GELU output for (B, T, hidden) x, f32
        (:class:`_GroupedConv`; the bias added to the bf16 product)."""
        conv, cd = self.wavlm.encoder.pos_conv_embed.conv, self.compute_dtype
        k = conv.weight_v.shape[-1]
        y = _GroupedConv.apply(x.to(cd), conv.weight().to(cd), conv.groups, k // 2)
        return tf.gelu(y[:, :x.shape[1]].float() + conv.bias.to(cd).float())

    def _position_bias(self, n: int, device) -> torch.Tensor:
        """Layer 0's ungated bias (heads, n, n), f32."""
        pos = torch.arange(n, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], self.num_buckets,
                                           self.max_bucket_distance)
        embed = self.wavlm.encoder.layers[0].attention.rel_attn_embed
        return embed(buckets).permute(2, 0, 1)

    def _attention(self, u: torch.Tensor, att: _Attention, pos_bias: torch.Tensor, draws):
        """Gated-bias self-attention of the LN1 output ``u`` (B, T, hidden)
        f32, through the output projection: (B, T, hidden) f32."""
        cd, heads = self.compute_dtype, self.heads
        b, t, hidden = u.shape
        hd = hidden // heads
        w = torch.cat([att.q_proj.weight, att.k_proj.weight, att.v_proj.weight]).to(cd)
        bias = torch.cat([att.q_proj.bias, att.k_proj.bias, att.v_proj.bias]).to(cd)
        qkv = tf.linear(u.to(cd), w, bias)  # (B, T, 3 hidden): q, k, v, each (heads, hd)
        # the gate, per head and query, from u's heads (f32)
        g = tf.linear(u.view(b, t, heads, hd), att.gru_rel_pos_linear.weight,
                      att.gru_rel_pos_linear.bias)
        g = torch.sigmoid(g.view(b, t, heads, 2, _GATE_WIDTH // 2).sum(-1))
        gate = g[..., 0] * (g[..., 1] * att.gru_rel_pos_const.view(heads) - 1.0) + 2.0
        mask, keep = _keep_mask(draws, (b, heads, t, t), self.attention_dropout, self.training)
        core = gated_bias_attention if cd == torch.bfloat16 else gated_bias_attention_plain
        ctx = core(qkv, gate, pos_bias, heads, mask, keep)
        return _linear(ctx, att.out_proj, cd).float()

    def _ffn(self, v: torch.Tensor, ff: _FeedForward, draws) -> torch.Tensor:
        cd = self.compute_dtype
        h = tf.gelu(_linear(v, ff.intermediate_dense, cd).float())
        h = _drop(h, draws, self.activation_dropout, self.training)
        return _linear(h, ff.output_dense, cd).float()

    def encode(self, x: torch.Tensor, dropout: Optional[DropoutDraws] = None) -> torch.Tensor:
        """(B, 1, win_len, hop) f32 wave windows -> (B, T, hidden) f32: the
        encoder's output after its final LayerNorm."""
        with span("wavlm.feature_encoder"):
            h = self._features(x.reshape(x.shape[0], -1), dropout)
        enc = self.wavlm.encoder
        h = _drop(h + self._pos_embed(h), dropout, self.hidden_dropout, self.training)
        pos_bias = self._position_bias(h.shape[1], h.device)
        if self.compute_dtype == torch.bfloat16:
            pos_bias = pos_bias.contiguous()  # the attention kernel reads it so, once a forward
        for layer in enc.layers:
            with span("wavlm.attention"):
                ln = layer.layer_norm
                u = tf.layer_norm(h, ln.normalized_shape, ln.weight, ln.bias, ln.eps)
                a = self._attention(u, layer.attention, pos_bias, dropout)
                h = h + _drop(a, dropout, self.hidden_dropout, self.training)
            with span("wavlm.ffn"):
                ln = layer.final_layer_norm
                v = tf.layer_norm(h, ln.normalized_shape, ln.weight, ln.bias, ln.eps)
                f = self._ffn(v, layer.feed_forward, dropout)
                h = h + _drop(f, dropout, self.hidden_dropout, self.training)
        return tf.layer_norm(h, enc.layer_norm.normalized_shape, enc.layer_norm.weight,
                             enc.layer_norm.bias, enc.layer_norm.eps)

    def forward(self, x: torch.Tensor, pooling: Optional[str] = "mean",
                dropout: Optional[DropoutDraws] = None, update_stats: bool = True,
                global_feature: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, 1, win_len, hop) wave windows -> (B, classes) f32 logits.
        ``pooling`` and ``update_stats`` are taken for the shared call and
        unused (the head mean-pools; there is no BatchNorm); a train-mode call
        with dropout needs ``dropout``.  No global feature."""
        if global_feature is not None:
            raise ValueError("wavlm-large takes no global feature")
        z = tf.linear(self.encode(x, dropout), self.projector.weight, self.projector.bias)
        return self.classifier(z.mean(1))
