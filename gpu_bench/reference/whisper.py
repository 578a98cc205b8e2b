"""The family module of ``whisper_large_v3_cloak_grl``: Whisper-large-v3's
encoder (Radford et al., arXiv:2212.04356; ``huggingface.co/openai/
whisper-large-v3``) with Hugging Face's audio-classification head as both
backbones of the cloak + GRL game, written out in plain torch.  What a
family module provides is listed in ``reference/cnn_bigru.py``.

The forward follows the published equations on parameter dictionaries
named as the program's state dict (``WhisperForAudioClassification``'s
names):

- stem: ``GELU(conv1(x))`` (k 3, pad 1), ``GELU(conv2(.))`` (k 3, stride 2,
  pad 1), then ``+ sinusoids``: ``[sin | cos]`` of ``t * exp(-i
  log(10000) / (d / 2 - 1))``, a fixed table;
- pre-LN layers: ``h = h + out_proj(softmax(q k^T / sqrt(hd)) v)`` over
  all frames with no mask or bias (``k_proj`` without a bias), ``h = h +
  fc2(GELU(fc1(LN2(h))))``; a final LayerNorm;
- head: projector -> mean over frames -> classifier.

Dropout, attention and activation dropout and LayerDrop are 0 in the
release: nothing is drawn.

Windows (:func:`windows`): Hugging Face's ``WhisperFeatureExtractor`` in
float64: the int16 / 32768 wave cut or zero-padded to ``n_samples``,
``torch.stft`` (n_fft, hop, periodic Hann, ``center=True``, reflect), the
last frame dropped, the power through the Slaney-scale, Slaney-normalized
128-band bank from 0 to 8 kHz (:func:`slaney_bank`, the formula written out
here), ``log10(max(., 1e-10))``, the clip's maximum minus 8 as a floor, and
``(L + 4) / 4``.  One window a clip.

Precision: ``BF16`` rounds to bf16 (``model.round_bf16``, the gradient too)
every operand of a matrix product or convolution, and stores its output,
summed in float32 with the bias added, rounded; the attention scores are
that product's rounded output, scaled in float32; LayerNorm, GELU, the
softmax, the residual stream and the head are float32.  ``FP8`` rounds at
the same places to float8 e4m3 in the forward: the control.  ``F32`` rounds
nowhere.

Blocks: float32 scores of one window's (20, 1500, 1500) attention take 180
MB a layer, and a batch of 8 windows through 32 layers of two encoders
keeps far more than the card holds for the backward.  So each backbone's
forward runs a window at a time under ``torch.utils.checkpoint`` (the
forward keeps only each window's input; the backward recomputes one window
and backbone at a time), and the loss's gradient is the sum of the
windows' gradients, as autograd adds them.  Nothing couples the windows:
Whisper has no BatchNorm.

Initial values (``init``): convolution and linear weights ``N(0, 1 /
fan_in)``, so a product keeps its input's scale; LayerNorm gains ``1 + 0.1
N`` and shifts ``0.1 N``; biases ``0.05 N``.  Every sublayer reads a
LayerNorm's unit-scale output and adds a term of about unit scale to the
residual stream (the FFN's; the attention's is smaller, an average of
values over diffuse scores), so the stream's scale grows as the square
root of the depth, to about 6 after 32 layers, over the stem's unit-scale
features and positions: each layer moves it by about a sixth or more, so
the eval forward is far from the identity, and the final LayerNorm keeps
the head's input at unit scale, so it does not blow up.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gpu_bench.harness import counts
from gpu_bench.reference import model as R
from gpu_bench.reference.model import BF16, F32, FP8, Draws, f32_off

__all__ = ["leaves", "init", "STATE_KINDS", "backbone_kwargs", "ingest_kwargs", "windows",
           "noise_shape", "baseline_loss", "grl_loss", "pinned_rows", "sgd_step", "Draws",
           "PRECISIONS", "f32_off", "slaney_bank", "sinusoids", "layer_flops", "forward_flops",
           "train_flops_per_window", "attention_calls", "attention_core_least_s", "counters",
           "backbone_forward", "TINY", "PUBLISHED"]

TINY = dict(d_model=64, encoder_layers=2, encoder_attention_heads=4, encoder_ffn_dim=128,
            num_mel_bins=16, max_source_positions=40, classifier_proj_size=16, win_len=80,
            feature_len=16, n_samples=12800)
PUBLISHED = dict(d_model=1280, encoder_layers=32, encoder_attention_heads=20,
                 encoder_ffn_dim=5120, num_mel_bins=128, max_source_positions=1500,
                 classifier_proj_size=256, win_len=3000, feature_len=128, n_fft=400, hop=160,
                 n_samples=480000)
STATE_KINDS = ()
# bf16 cells only: the reference's precision and the control's
PRECISIONS = {"bfloat16": (BF16, FP8)}
_WIDTHS = ("d_model", "encoder_layers", "encoder_attention_heads", "encoder_ffn_dim",
           "num_mel_bins", "max_source_positions", "classifier_proj_size")
_LN_EPS = 1e-5
_AMIN = 1e-10  # the power's floor before log10
_TOP = 8.0  # the log-mel floor: the clip's maximum minus this


# -- leaves and their initial values ------------------------------------------

def _backbone_leaves(cfg: dict, pred: str, prefix: str) -> dict:
    d, ffn, mels = cfg["d_model"], cfg["encoder_ffn_dim"], cfg["num_mel_bins"]
    out = {}

    def linear(name, n_out, n_in, bias=True):
        out[f"{prefix}{name}.weight"] = ((n_out, n_in), "dense_w")
        if bias:
            out[f"{prefix}{name}.bias"] = ((n_out,), "bias")

    def norm(name, n):
        out[f"{prefix}{name}.weight"] = ((n,), "ln_w")
        out[f"{prefix}{name}.bias"] = ((n,), "ln_b")

    for name, c_in in (("encoder.conv1", mels), ("encoder.conv2", d)):
        out[f"{prefix}{name}.weight"] = ((d, c_in, 3), "conv_w")
        out[f"{prefix}{name}.bias"] = ((d,), "bias")
    for i in range(cfg["encoder_layers"]):
        layer = f"encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{layer}.self_attn.{proj}", d, d, bias=proj != "k_proj")
        norm(f"{layer}.self_attn_layer_norm", d)
        linear(f"{layer}.fc1", ffn, d)
        linear(f"{layer}.fc2", d, ffn)
        norm(f"{layer}.final_layer_norm", d)
    norm("encoder.layer_norm", d)
    linear("projector", cfg["classifier_proj_size"], d)
    linear("classifier", cfg["classes"][pred], cfg["classifier_proj_size"])
    return out


def leaves(cfg: dict) -> dict:
    if cfg["task"] == "baseline":
        return _backbone_leaves(cfg, cfg["pred"], "")
    if cfg["task"] == "cloak_grl":
        shape = noise_shape(cfg)
        out = {"noise.locs": (shape, "noise_loc"), "noise.rhos": (shape, "noise_rho")}
        out.update(_backbone_leaves(cfg, "emotion", "emotion_backbone."))
        out.update(_backbone_leaves(cfg, "gender", "gender_backbone."))
        return out
    raise ValueError(f"unknown task {cfg['task']!r}")


def init(cfg: dict, name: str, kind: str, shape, n: torch.Tensor) -> torch.Tensor:
    """A leaf's initial value from standard normals ``n``, scaled by kind
    (the module's docstring says why)."""
    if kind in ("conv_w", "dense_w"):
        t = n / math.sqrt(math.prod(shape[1:]))
    elif kind == "bias":
        t = 0.05 * n
    elif kind == "ln_w":
        t = 1.0 + 0.1 * n
    elif kind == "ln_b":
        t = 0.1 * n
    elif kind == "noise_loc":
        t = 0.05 * n
    elif kind == "noise_rho":
        t = -2.0 + 0.5 * n
    else:
        raise ValueError(kind)
    return t.contiguous()


def backbone_kwargs(cfg: dict) -> dict:
    return {"model_type": cfg["model_type"], **{k: cfg[k] for k in _WIDTHS}}


def ingest_kwargs(cfg: dict) -> dict:
    return {"n_fft": cfg["n_fft"], "n_mels": cfg["num_mel_bins"], "win_len": cfg["win_len"]}


# -- windows ------------------------------------------------------------------

def _hz_to_mel(f: torch.Tensor) -> torch.Tensor:
    """Slaney's scale: linear to 1 kHz (3 mels / 200 Hz), logarithmic above
    (27 mels an octave of 6.4)."""
    return torch.where(f >= 1000.0, 15.0 + torch.log(f / 1000.0) * (27.0 / math.log(6.4)),
                       3.0 * f / 200.0)


def _mel_to_hz(m: torch.Tensor) -> torch.Tensor:
    return torch.where(m >= 15.0, 1000.0 * torch.exp((m - 15.0) * (math.log(6.4) / 27.0)),
                       200.0 * m / 3.0)


def slaney_bank(n_fft: int, n_mels: int, sample_rate: int = 16000, f_max: float = 8000.0,
                device=None) -> torch.Tensor:
    """(n_fft // 2 + 1, n_mels) float64: triangles between n_mels + 2 points
    evenly spaced on Slaney's scale from 0 to ``f_max``, over the bins
    ``linspace(0, sample_rate // 2, n_fft // 2 + 1)``, each scaled by 2 /
    its width in Hz (unit area)."""
    f64 = dict(dtype=torch.float64, device=device)
    freqs = torch.linspace(0, sample_rate // 2, n_fft // 2 + 1, **f64)
    top = _hz_to_mel(torch.tensor(f_max, **f64))
    pts = _mel_to_hz(torch.linspace(0.0, 1.0, n_mels + 2, **f64) * top)
    width = pts[1:] - pts[:-1]
    slopes = pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / width[:-1]
    up = slopes[:, 2:] / width[1:]
    bank = torch.clamp(torch.minimum(down, up), min=0.0)
    return bank * (2.0 / (pts[2:] - pts[:-2]))[None, :]


def windows(waves: torch.Tensor, speakers: torch.Tensor, rows, cfg: dict) -> torch.Tensor:
    """The windows ``rows`` (one a clip) of an ingest of (N, L) int16 waves:
    Whisper's features, (len(rows), win_len, num_mel_bins) float64."""
    n_fft, hop, size = cfg["n_fft"], cfg["hop"], cfg["n_samples"]
    if size != cfg["win_len"] * hop:
        raise ValueError("n_samples must be win_len * hop")
    rows = torch.as_tensor(rows, dtype=torch.long, device=waves.device)
    x = waves[rows, :size].to(torch.float64) / 32768.0
    x = F.pad(x, (0, size - x.shape[1]))
    window = torch.hann_window(n_fft, periodic=True, dtype=torch.float64, device=x.device)
    spec = torch.stft(x, n_fft, hop, window=window, center=True, pad_mode="reflect",
                      return_complex=True)[..., :-1]
    power = spec.real ** 2 + spec.imag ** 2  # (B, n_fft // 2 + 1, frames)
    bank = slaney_bank(n_fft, cfg["num_mel_bins"], cfg["sample_rate"], device=x.device)
    log = torch.log10(torch.clamp(bank.t() @ power, min=_AMIN))
    log = torch.maximum(log, log.amax((1, 2), keepdim=True) - _TOP)
    return ((log + 4.0) / 4.0).transpose(1, 2)


def noise_shape(cfg: dict) -> tuple:
    return (1, cfg["win_len"], cfg["num_mel_bins"])


def pinned_rows(name: str, cfg: dict):
    return None  # every row of every leaf is a parameter


def sgd_step(p: dict, grads: dict, bufs: dict, opt: dict, cfg: dict) -> None:
    R.sgd_step(p, grads, bufs, opt, 0)


# -- the forward --------------------------------------------------------------

def sinusoids(length: int, channels: int, device=None) -> torch.Tensor:
    """Whisper's (length, channels) position table, float32."""
    inc = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, device=device))
    t = torch.arange(length, device=device).view(-1, 1) * inv.view(1, -1)
    return torch.cat([t.sin(), t.cos()], dim=1)


def backbone_forward(p: dict, x: torch.Tensor, cfg: dict, pred: str, train: bool,
                     draws=None, prefix: str = "", prec=F32) -> torch.Tensor:
    """(B, 1, win_len, mels) log-mel windows -> (B, classes) logits of one
    backbone.  ``train`` and ``draws`` are taken for the shared call: with
    no dropout, train and eval forwards are the same function."""
    r = prec.store or (lambda t: t)
    heads = cfg["encoder_attention_heads"]
    hd = cfg["d_model"] // heads

    def w(name):
        return p[f"{prefix}{name}"]

    def linear(t, name, bias=True):
        y = r(t) @ r(w(f"{name}.weight")).t()
        return r(y + r(w(f"{name}.bias"))) if bias else r(y)

    def ln(t, name):
        return F.layer_norm(t, t.shape[-1:], w(f"{name}.weight"), w(f"{name}.bias"), _LN_EPS)

    h = x[:, 0].transpose(1, 2)  # (B, mels, frames)
    for name, stride in (("encoder.conv1", 1), ("encoder.conv2", 2)):
        h = F.gelu(r(F.conv1d(r(h), r(w(f"{name}.weight")), r(w(f"{name}.bias")), stride=stride,
                              padding=1)))
    h = h.transpose(1, 2)
    b, t, d = h.shape
    h = h + sinusoids(t, d, h.device)
    for i in range(cfg["encoder_layers"]):
        layer = f"encoder.layers.{i}"
        u = ln(h, f"{layer}.self_attn_layer_norm")

        def split(name, bias=True):
            return linear(u, f"{layer}.self_attn.{name}", bias).view(b, t, heads, hd).transpose(
                1, 2)

        q, k, v = split("q_proj"), split("k_proj", bias=False), split("v_proj")
        probs = torch.softmax(r(q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(hd)), -1)
        ctx = r(r(probs) @ v).transpose(1, 2).reshape(b, t, d)
        h = h + linear(ctx, f"{layer}.self_attn.out_proj")
        f = F.gelu(linear(ln(h, f"{layer}.final_layer_norm"), f"{layer}.fc1"))
        h = h + linear(f, f"{layer}.fc2")
    h = ln(h, "encoder.layer_norm")
    z = (h @ w("projector.weight").t() + w("projector.bias")).mean(1)
    return z @ w("classifier.weight").t() + w("classifier.bias")


def _by_window(p: dict, x: torch.Tensor, cfg: dict, pred: str, train: bool, prefix: str,
               prec) -> torch.Tensor:
    """One backbone's logits of (B, 1, win_len, mels) windows, a window at
    a time, each recomputed in the backward (the module's docstring)."""

    def one(xi):
        return backbone_forward(p, xi, cfg, pred, train, None, prefix, prec)

    return torch.cat([checkpoint(one, x[i:i + 1], use_reentrant=False)
                      for i in range(x.shape[0])])


def grl_forward(p: dict, x: torch.Tensor, cfg: dict, eps: torch.Tensor, draws, prec=F32):
    """(emotion logits, gender logits) of the cloak + GRL game under one
    noise draw ``eps`` (1, win_len, mels): the frozen emotion backbone and
    the gender backbone behind the reversal."""
    noised = (x[:, 0] + (p["noise.locs"] + R.noise_scales(p, cfg) * eps))[:, None]
    emo = _by_window(p, noised, cfg, "emotion", False, "emotion_backbone.", prec)
    gen = _by_window(p, R._Reverse.apply(noised, cfg["grl_lambda"]), cfg, "gender", True,
                     "gender_backbone.", prec)
    return emo, gen


def grl_loss(p, x, labels_emo, labels_gen, weights, cfg, eps, draws, prec=F32):
    emo, gen = grl_forward(p, x, cfg, eps, draws, prec)
    loss = (R.weighted_ce(emo, labels_emo, weights)
            + cfg["gender_lambda"] * R.weighted_ce(gen, labels_gen, weights))
    return loss - cfg["scale_lambda"] * torch.log(R.noise_scales(p, cfg).mean())


def baseline_loss(p, x, labels, weights, cfg, draws, prec=F32):
    return R.weighted_ce(_by_window(p, x, cfg, cfg["pred"], True, "", prec), labels, weights)


# -- FLOPs and the attention core's least time ---------------------------------

def layer_flops(cfg: dict) -> dict:
    """FLOPs of one forward of a backbone on one window, by part: the
    multiply-adds (2 each) of the two convolutions, each layer's four
    projections, scores and values, and FFN, and the head.  Elementwise
    work (LayerNorm, GELU, softmax, the positions, the mean) is left out."""
    d, ffn, mels = cfg["d_model"], cfg["encoder_ffn_dim"], cfg["num_mel_bins"]
    frames = cfg["win_len"]
    t = frames // 2
    out = {"conv1": 2.0 * frames * d * mels * 3, "conv2": 2.0 * t * d * d * 3}
    per_layer = 2.0 * t * 4 * d * d + 2.0 * 2 * t * t * d + 2.0 * 2 * t * d * ffn
    for i in range(cfg["encoder_layers"]):
        out[f"layer{i}"] = per_layer
    n_cls = cfg["classes"][cfg.get("pred", "emotion")]
    p_size = cfg["classifier_proj_size"]
    out["head"] = 2.0 * t * d * p_size + 2.0 * p_size * n_cls
    return out


def forward_flops(cfg: dict) -> float:
    """F: one eval or train forward of a backbone on one window."""
    return sum(layer_flops(cfg).values())


def train_flops_per_window(cfg: dict) -> float:
    """One training step's FLOPs per window: ``baseline`` forward, weight
    and input gradients, 3F; ``cloak_grl`` the frozen emotion backbone's
    forward and input gradient and the gender backbone's forward, weight and
    input gradients, 5F."""
    f = forward_flops(cfg)
    if cfg["task"] == "baseline":
        return 3.0 * f
    if cfg["task"] == "cloak_grl":
        return 5.0 * f
    raise ValueError(f"unknown task {cfg['task']!r}")


def attention_calls(cfg: dict) -> tuple:
    """(forward, backward) calls of the attention core a training step: a
    layer each in every backbone the step runs forward and carries a
    gradient through (``cloak_grl``: both, since the frozen emotion
    backbone carries the gradient to the noise)."""
    n = cfg["encoder_layers"] * (2 if cfg["task"] == "cloak_grl" else 1)
    return n, n


def attention_core_least_s(cfg: dict, batch: int) -> float:
    """Least seconds of a training step's attention cores at the bf16
    peak (``harness/counts.py``): each forward call 4 B H T^2 hd FLOPs
    (the scores and P v) and its q, k, v and output in bf16; each backward
    call 8 B H T^2 hd (dV, dP, dQ, dK) and q, k, v, the output, its gradient
    and dq, dk, dv.  The work the mathematics needs, not the recomputation
    of P an implementation chooses."""
    t, d = cfg["win_len"] // 2, cfg["d_model"]
    core = batch * t * t * d  # B H T^2 hd
    tensor = 2.0 * batch * t * d  # one (B, T, d) bf16 tensor
    fwd, bwd = attention_calls(cfg)
    return (fwd * counts.bound(4.0 * core, 4 * tensor, counts.PEAK_BF16_FLOPS)
            + bwd * counts.bound(8.0 * core, 8 * tensor, counts.PEAK_BF16_FLOPS))


def counters() -> dict:
    """The streaming self-attention's launch counters."""
    return {f"self_attention.{attr}": ("sept_tpu_torch.ops.attention", "self_attention", attr)
            for attr in ("launches", "launches_bwd")}
