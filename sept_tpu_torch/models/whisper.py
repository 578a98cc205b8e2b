"""Whisper-large-v3's encoder as a backbone of the port, with Hugging Face's
audio-classification head.

Radford et al., "Robust Speech Recognition via Large-Scale Weak
Supervision" (arXiv:2212.04356), at the widths of the
``openai/whisper-large-v3`` release.  Parameter names are those of Hugging
Face's ``WhisperForAudioClassification`` (``encoder.conv1``,
``encoder.layers.{i}.self_attn.{q,k,v,out}_proj``,
``self_attn_layer_norm``, ``fc1``, ``fc2``, ``final_layer_norm``,
``encoder.layer_norm``, ``projector``, ``classifier``).

The layers, on (B, 1, win_len, num_mel_bins) log-mel windows (frames by
mels: ``device_ingest``'s ``"whisper"`` frontend):

- stem: ``GELU(Conv1d(mels -> d, k 3, pad 1))``, then ``GELU(Conv1d(d ->
  d, k 3, stride 2, pad 1))``, which halves the frames (3,000 -> 1,500),
  then ``+ sinusoids(T, d)``: ``[sin | cos]`` of ``t * exp(-i log(10000) /
  (d / 2 - 1))``, a buffer and not a parameter (Hugging Face's frozen
  ``embed_positions``);
- ``encoder_layers`` pre-LN layers: ``h = h + out_proj(Attn(LN1(h)))``,
  ``h = h + fc2(GELU(fc1(LN2(h))))``; ``Attn = softmax(q k^T /
  sqrt(head_dim)) v`` over all frames, per head, with no mask, bias or
  dropout; ``k_proj`` has no bias; a final LayerNorm;
- head (``use_weighted_layer_sum`` false): ``projector`` Linear(d ->
  classifier_proj_size) -> the mean over frames -> ``classifier``.

GELU is the exact (erf) one.  Dropout, attention dropout, activation
dropout and LayerDrop are 0 in the release, so nothing is drawn from
``DropoutDraws``: train and eval forwards compute the same function.

``compute_dtype`` ``torch.bfloat16`` is the port's bf16 class, as in
``models/wavlm.py``: the operands of every product and convolution are
rounded to bf16 and their outputs (summed in f32, the bias added) stored
in bf16; parameters stay f32; the residual stream, every LayerNorm, GELU
and the softmax are f32.  ``projector`` and ``classifier`` are f32.  The
FFN's GELU takes fc1's bf16 output as it is and returns bf16, fc2's
operand: it computes in f32 inside, so the bits are those of an f32 GELU
rounded for fc2, and its backward keeps fc1's output in bf16, half the
bytes of an f32 copy (10 kB a frame and layer at the published widths,
7.9 GB a GRL step at batch 8); fc2's backward recomputes the GELU from it
rather than keep the GELU's output for fc2's weight gradient (another 10 kB
a frame and layer of the trained backbone, 3.9 GB a step), so that the
eager step fits on the card beside a captured step's memory pool.  The
attention core is :func:`~sept_tpu_torch.ops.attention.self_attention`,
which streams over key tiles on a card and never holds the (B, heads, T,
T) scores.

The convolutions run as products of unfolded frames, frames by channels
throughout, as in ``models/wavlm.py``; the products take ``wavlm._linear``.

In a ``torch.profiler`` session the forward opens ``whisper.stem`` around
the two convolutions, their GELUs and the positions, and in each layer
``whisper.attention`` (LN1, the QKV product, the core, the output
projection and the residual) and ``whisper.ffn`` (LN2, fc1, GELU, fc2 and
the residual).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as tf
from torch import nn

from sept_tpu_torch.models.backbone import NUM_EMO_CLASSES, NUM_GENDER_CLASSES, DropoutDraws
from sept_tpu_torch.models.wavlm import _linear
from sept_tpu_torch.ops.attention import self_attention
from sept_tpu_torch.utils.profiling import span

__all__ = ["Whisper", "sinusoids"]


def sinusoids(length: int, channels: int, max_timescale: float = 10000.0) -> torch.Tensor:
    """Whisper's (length, channels) position table, f32: ``[sin | cos]`` of
    ``t * exp(-i log(max_timescale) / (channels / 2 - 1))``."""
    inc = math.log(max_timescale) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2))
    t = torch.arange(length).view(-1, 1) * inv.view(1, -1)
    return torch.cat([t.sin(), t.cos()], dim=1)


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d, bias=False)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class _Layer(nn.Module):
    def __init__(self, d: int, ffn: int):
        super().__init__()
        self.self_attn = _Attention(d)
        self.self_attn_layer_norm = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)
        self.final_layer_norm = nn.LayerNorm(d)


class _Encoder(nn.Module):
    def __init__(self, mels: int, d: int, layers: int, ffn: int, positions: int):
        super().__init__()
        self.conv1 = nn.Conv1d(mels, d, 3, padding=1)
        self.conv2 = nn.Conv1d(d, d, 3, stride=2, padding=1)
        self.register_buffer("embed_positions", sinusoids(positions, d), persistent=False)
        self.layers = nn.ModuleList(_Layer(d, ffn) for _ in range(layers))
        self.layer_norm = nn.LayerNorm(d)


def _ln(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return tf.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps)


def _gelu_linear(a: torch.Tensor, lin: nn.Linear, cd: torch.dtype) -> torch.Tensor:
    """``_linear(GELU(a), lin, cd)`` whose backward recomputes GELU(a) from
    ``a``, which GELU's backward keeps anyway, where the product would keep
    GELU(a) for its weight gradient: the same kernels on the same values,
    so the same bits, and one (B, T, ffn) tensor a layer less to keep."""
    g = tf.gelu(a)
    ptr, n = g.data_ptr(), g.numel()

    def pack(t):
        if t.data_ptr() == ptr and t.numel() == n:
            return t.size(), t.stride(), t.storage_offset()
        return t

    def unpack(saved):
        if isinstance(saved, tuple):
            return tf.gelu(a).as_strided(*saved)
        return saved

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        return _linear(g, lin, cd)


class Whisper(nn.Module):
    """Whisper-large-v3's encoder (``whisper-large-v3``): (B, 1, win_len,
    num_mel_bins) log-mel windows -> (B, classes) logits of ``pred``, with
    win_len = 2 * max_source_positions.  Defaults are the published
    widths."""

    def __init__(self, pred: str = "emotion", d_model: int = 1280, encoder_layers: int = 32,
                 encoder_attention_heads: int = 20, encoder_ffn_dim: int = 5120,
                 num_mel_bins: int = 128, max_source_positions: int = 1500,
                 classifier_proj_size: int = 256,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if pred not in ("emotion", "gender"):
            raise ValueError(f"unknown pred: {pred!r}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be torch.float32 or torch.bfloat16, "
                             f"got {compute_dtype}")
        if d_model % encoder_attention_heads:
            raise ValueError("d_model is not a multiple of encoder_attention_heads")
        self.pred, self.compute_dtype = pred, compute_dtype
        self.heads, self.positions = encoder_attention_heads, max_source_positions
        self.encoder = _Encoder(num_mel_bins, d_model, encoder_layers, encoder_ffn_dim,
                                max_source_positions)
        self.projector = nn.Linear(d_model, classifier_proj_size)
        n_cls = NUM_EMO_CLASSES if pred == "emotion" else NUM_GENDER_CLASSES
        self.classifier = nn.Linear(classifier_proj_size, n_cls)

    def _conv(self, x: torch.Tensor, conv: nn.Conv1d) -> torch.Tensor:
        """GELU of a k-3 Conv1d over (B, T, C_in) frames with one zero frame
        each side, as one product of the unfolded frames (stored whole: the
        CPU's bf16 product of the overlapping view sums less exactly):
        (B, T', C_out) f32."""
        cd, w = self.compute_dtype, conv.weight
        cols = tf.pad(x, (0, 0, 1, 1)).to(cd).unfold(1, 3, conv.stride[0]).transpose(-1, -2)
        cols = cols.reshape(x.shape[0], -1, 3 * w.shape[1]).contiguous()
        y = tf.linear(cols, w.to(cd).transpose(1, 2).reshape(w.shape[0], -1), conv.bias.to(cd))
        return tf.gelu(y.float())

    def _attention(self, u: torch.Tensor, att: _Attention) -> torch.Tensor:
        """Self-attention of the LN1 output ``u`` (B, T, d) f32 through the
        output projection: (B, T, d) f32."""
        cd = self.compute_dtype
        w = torch.cat([att.q_proj.weight, att.k_proj.weight, att.v_proj.weight]).to(cd)
        bias = torch.cat([att.q_proj.bias, torch.zeros_like(att.q_proj.bias),
                          att.v_proj.bias]).to(cd)
        ctx = self_attention(tf.linear(u.to(cd), w, bias), self.heads)
        return _linear(ctx, att.out_proj, cd).float()

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, win_len, mels) f32 windows -> (B, T, d) f32: the encoder's
        output after its final LayerNorm."""
        enc, cd = self.encoder, self.compute_dtype
        if x.shape[-2] != 2 * self.positions:
            raise ValueError(f"whisper-large-v3 takes {2 * self.positions} frames, "
                             f"got {x.shape[-2]}")
        with span("whisper.stem"):
            h = self._conv(self._conv(x[:, 0], enc.conv1), enc.conv2)
            h = h + enc.embed_positions
        for layer in enc.layers:
            with span("whisper.attention"):
                h = h + self._attention(_ln(h, layer.self_attn_layer_norm), layer.self_attn)
            with span("whisper.ffn"):
                f = _linear(_ln(h, layer.final_layer_norm), layer.fc1, cd)
                h = h + _gelu_linear(f, layer.fc2, cd).float()
        return _ln(h, enc.layer_norm)

    def forward(self, x: torch.Tensor, pooling: Optional[str] = "mean",
                dropout: Optional[DropoutDraws] = None, update_stats: bool = True,
                global_feature: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, 1, win_len, mels) log-mel windows -> (B, classes) f32 logits.
        ``pooling``, ``dropout`` and ``update_stats`` are taken for the
        shared call and unused (the head mean-pools; nothing is dropped;
        there is no BatchNorm).  No global feature."""
        if global_feature is not None:
            raise ValueError("whisper-large-v3 takes no global feature")
        z = tf.linear(self.encode(x), self.projector.weight, self.projector.bias)
        return self.classifier(z.mean(1))
