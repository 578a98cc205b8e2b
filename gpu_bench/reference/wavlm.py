"""The family module of ``wavlm_large_cloak_grl``: WavLM-Large (Chen et al.,
arXiv:2110.13900; ``huggingface.co/microsoft/wavlm-large``) as both
backbones of the cloak + GRL game, written out in plain torch.  What a
family module provides is listed in ``reference/cnn_bigru.py``.

The forward follows the published layer equations on parameter
dictionaries named as the program's state dict (Hugging Face's
``WavLMForSequenceClassification`` names):

- feature encoder: 7 x [Conv1d (no bias unless ``conv_bias``) ->
  LayerNorm over the channels -> GELU] over the wave window;
- feature projection: LayerNorm -> Linear -> dropout (``feat_proj_dropout``);
- positional convolution: ``x + GELU(conv + bias)`` with the weight
  ``weight_g * weight_v / ||weight_v||`` (norm over all dims but the
  kernel's), padding k // 2, the last frame dropped for an even k, groups;
  then dropout (``hidden_dropout``);
- pre-LN layers: ``h = x + drop(out_proj(softmax(q k^T / sqrt(d) + gate *
  bias) v))`` with dropout on the probabilities, ``x' = h + drop(W2
  GELU(W1 LN2(h)))``; the bias ``rel_attn_embed[bucket(j - i)]`` of layer 0
  (:func:`bucket`), gated per layer, head and query by ``g =
  sigmoid(pairwise sums of Linear(d -> 8)(LN1(x) by heads))``, ``gate =
  g_a * (g_b * c_h - 1) + 2``; a final LayerNorm;
- head: projector -> mean over frames -> classifier.

LayerDrop (0.1 in the release) and SpecAugment are off: the configuration's
``assumed``.

Windows: the int16 / 32768 wave cut into (win_len * hop)-sample windows
every shift_len * hop samples, each normalized to zero mean and unit
variance, ``(x - mean) / sqrt(var + 1e-7)`` (biased variance), float64.

Precision: ``BF16`` rounds to bf16 (``model.round_bf16``, the gradient too)
every operand of a matrix product or convolution, and stores its output,
summed in float32 with the bias added, rounded (the positional
convolution's bias is added to the rounded product); LayerNorm, GELU, softmax,
the position bias and its gate, the residual stream and the head are
float32.  ``FP8`` rounds at the same places to float8 e4m3 in the forward:
the control.  ``F32`` rounds nowhere (the CPU tests hold the program's
float32 mode to it).  Dropout masks come from ``Draws`` in the program's
order: the projection's, the positional embedding's, then a layer's
attention probabilities, attention output, FFN activation (none at rate 0)
and FFN output.

Initial values (``init``): convolution and linear weights ``N(0, 1 /
fan_in)``, so a product keeps its input's scale; LayerNorm gains ``1 +
0.1 N`` and shifts ``0.1 N``; biases ``0.05 N``; ``weight_v`` ``N(0, 1)``
and ``weight_g`` ``sqrt(hidden / k) (1 + 0.1 N)``, which gives the
positional weight ``N(0, 1 / fan_in)`` too; the gate's constants ``1 + 0.1
N``; the bias table ``0.5 N``, comparable to the unit-scale scores
``q k^T / 8`` it is added to.  Every sublayer reads a LayerNorm's output and
adds a unit-scale term to the residual stream, whose scale then grows as
the square root of the depth (about 7 after 24 layers) and is normalized
again before the head: the eval forward is far from the identity and does
not blow up.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpu_bench.reference import model as R
from gpu_bench.reference.model import BF16, F32, FP8, Draws, f32_off

__all__ = ["leaves", "init", "STATE_KINDS", "backbone_kwargs", "ingest_kwargs", "windows",
           "noise_shape", "baseline_loss", "grl_loss", "pinned_rows", "sgd_step", "Draws",
           "PRECISIONS", "f32_off", "bucket", "frames", "layer_flops", "forward_flops",
           "train_flops_per_window", "counters", "backbone_forward", "TINY", "PUBLISHED"]

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
            conv_dim=[16] * 7, num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=4,
            num_buckets=32, max_bucket_distance=40, classifier_proj_size=8, win_len=48,
            shift_len=12)
PUBLISHED = dict(hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
                 intermediate_size=4096, conv_dim=[512] * 7, conv_kernel=[10, 3, 3, 3, 3, 2, 2],
                 conv_stride=[5, 2, 2, 2, 2, 2, 2], num_conv_pos_embeddings=128,
                 num_conv_pos_embedding_groups=16, num_buckets=320, max_bucket_distance=800,
                 layer_norm_eps=1e-5, classifier_proj_size=256, hidden_dropout=0.1,
                 attention_dropout=0.1, activation_dropout=0.0, win_len=200, shift_len=50,
                 hop=160)
STATE_KINDS = ()
# bf16 cells only: the reference's precision and the control's
PRECISIONS = {"bfloat16": (BF16, FP8)}
_WIDTHS = ("hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size",
           "conv_dim", "conv_kernel", "conv_stride", "conv_bias", "num_conv_pos_embeddings",
           "num_conv_pos_embedding_groups", "num_buckets", "max_bucket_distance",
           "layer_norm_eps", "classifier_proj_size", "hidden_dropout", "attention_dropout",
           "activation_dropout", "feat_proj_dropout")
_GATE = 8  # the gate's linear outputs: 2 gates x 4 summed
_WAVE_EPS = 1e-7


# -- leaves and their initial values ------------------------------------------

def _backbone_leaves(cfg: dict, pred: str, prefix: str) -> dict:
    h, heads, inter = cfg["hidden_size"], cfg["num_attention_heads"], cfg["intermediate_size"]
    out = {}

    def linear(name, n_out, n_in):
        out[f"{prefix}{name}.weight"] = ((n_out, n_in), "dense_w")
        out[f"{prefix}{name}.bias"] = ((n_out,), "bias")

    def norm(name, n):
        out[f"{prefix}{name}.weight"] = ((n,), "ln_w")
        out[f"{prefix}{name}.bias"] = ((n,), "ln_b")

    c_in = 1
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        layer = f"wavlm.feature_extractor.conv_layers.{i}"
        out[f"{prefix}{layer}.conv.weight"] = ((c, c_in, k), "conv_w")
        if cfg["conv_bias"]:
            out[f"{prefix}{layer}.conv.bias"] = ((c,), "bias")
        norm(f"{layer}.layer_norm", c)
        c_in = c
    norm("wavlm.feature_projection.layer_norm", c_in)
    linear("wavlm.feature_projection.projection", h, c_in)
    pos, k = f"{prefix}wavlm.encoder.pos_conv_embed.conv", cfg["num_conv_pos_embeddings"]
    out[f"{pos}.weight_g"] = ((1, 1, k), "pos_g")
    out[f"{pos}.weight_v"] = ((h, h // cfg["num_conv_pos_embedding_groups"], k), "pos_v")
    out[f"{pos}.bias"] = ((h,), "bias")
    norm("wavlm.encoder.layer_norm", h)
    for i in range(cfg["num_hidden_layers"]):
        layer = f"wavlm.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{layer}.attention.{proj}", h, h)
        out[f"{prefix}{layer}.attention.gru_rel_pos_const"] = ((1, heads, 1, 1), "gate_const")
        linear(f"{layer}.attention.gru_rel_pos_linear", _GATE, h // heads)
        if i == 0:
            out[f"{prefix}{layer}.attention.rel_attn_embed.weight"] = (
                (cfg["num_buckets"], heads), "rel_embed")
        norm(f"{layer}.layer_norm", h)
        linear(f"{layer}.feed_forward.intermediate_dense", inter, h)
        linear(f"{layer}.feed_forward.output_dense", h, inter)
        norm(f"{layer}.final_layer_norm", h)
    linear("projector", cfg["classifier_proj_size"], h)
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
    elif kind in ("ln_w", "gate_const"):
        t = 1.0 + 0.1 * n
    elif kind == "ln_b":
        t = 0.1 * n
    elif kind == "pos_v":
        t = n
    elif kind == "pos_g":
        t = math.sqrt(cfg["hidden_size"] / shape[-1]) * (1.0 + 0.1 * n)
    elif kind == "rel_embed":
        t = 0.5 * n
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
    return {"win_len": cfg["win_len"], "shift_len": cfg["shift_len"]}


def windows(waves: torch.Tensor, speakers: torch.Tensor, rows, cfg: dict) -> torch.Tensor:
    """The training windows ``rows`` of an ingest of (N, L) int16 waves of
    one length, utterance-major: (len(rows), win_len, hop) float64."""
    hop = cfg["hop"]
    size, stride = cfg["win_len"] * hop, cfg["shift_len"] * hop
    n_win = (waves.shape[1] - size) // stride + 1
    rows = torch.as_tensor(rows, dtype=torch.long, device=waves.device)
    start = (rows % n_win) * stride
    idx = start[:, None] + torch.arange(size, device=waves.device)
    x = torch.gather(waves[rows // n_win], 1, idx).to(torch.float64) / 32768.0
    x = x - x.mean(-1, keepdim=True)
    x = x / torch.sqrt((x * x).mean(-1, keepdim=True) + _WAVE_EPS)
    return x.view(len(rows), cfg["win_len"], hop)


def noise_shape(cfg: dict) -> tuple:
    return (1, cfg["win_len"], cfg["hop"])


def pinned_rows(name: str, cfg: dict):
    return None  # every row of every leaf is a parameter


def sgd_step(p: dict, grads: dict, bufs: dict, opt: dict, cfg: dict) -> None:
    R.sgd_step(p, grads, bufs, opt, 0)


# -- the forward --------------------------------------------------------------

def bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """WavLM's bucket of each relative position ``rel`` (key - query): half
    the buckets a direction, positive distances in the upper half; under a
    quarter of ``num_buckets`` one bucket a distance, then log-spaced up to
    ``max_distance``, the last bucket holding every distance past it."""
    half = num_buckets // 2
    exact = half // 2
    d = rel.abs()
    log_part = (torch.log(d.float() / exact) / math.log(max_distance / exact)
                * (half - exact))
    far = torch.clamp((exact + log_part).to(torch.long), max=half - 1)
    return torch.where(rel > 0, half, 0) + torch.where(d < exact, d, far)


def _drop(x, draws, rate, train):
    if not train or rate == 0.0:
        return x
    keep = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    return torch.where(draws.keep(x.shape, rate), x / keep, torch.zeros_like(x))


def _ln(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def backbone_forward(p: dict, x: torch.Tensor, cfg: dict, pred: str, train: bool,
                     draws=None, prefix: str = "", prec=F32) -> torch.Tensor:
    """(B, 1, win_len, hop) wave windows -> (B, classes) logits of one
    backbone; train mode draws dropout from ``draws``."""
    r = prec.store or (lambda t: t)
    eps, heads = cfg["layer_norm_eps"], cfg["num_attention_heads"]
    hd = cfg["hidden_size"] // heads

    def w(name):
        return p[f"{prefix}{name}"]

    def linear(t, name):
        return r(r(t) @ r(w(f"{name}.weight")).t() + r(w(f"{name}.bias")))

    def ln(t, name):
        return _ln(t, p, f"{prefix}{name}", eps)

    # feature encoder: the channels last after each conv for the LayerNorm
    h = x.reshape(x.shape[0], 1, -1)
    for i, s in enumerate(cfg["conv_stride"]):
        layer = f"wavlm.feature_extractor.conv_layers.{i}"
        b = w(f"{layer}.conv.bias") if cfg["conv_bias"] else None
        y = r(F.conv1d(r(h), r(w(f"{layer}.conv.weight")), None if b is None else r(b),
                       stride=s))
        h = F.gelu(ln(y.transpose(1, 2), f"{layer}.layer_norm")).transpose(1, 2)
    h = ln(h.transpose(1, 2), "wavlm.feature_projection.layer_norm")
    h = _drop(linear(h, "wavlm.feature_projection.projection"), draws,
              cfg["feat_proj_dropout"], train)
    # positional convolution
    pos = "wavlm.encoder.pos_conv_embed.conv"
    v = w(f"{pos}.weight_v")
    k = v.shape[-1]
    wt = w(f"{pos}.weight_g") * v / torch.sqrt((v * v).sum((0, 1), keepdim=True))
    y = r(F.conv1d(r(h.transpose(1, 2)), r(wt), padding=k // 2,
                   groups=cfg["num_conv_pos_embedding_groups"]))
    y = y[..., :h.shape[1]] + r(w(f"{pos}.bias"))[:, None]
    h = _drop(h + F.gelu(y).transpose(1, 2), draws, cfg["hidden_dropout"], train)
    # the layers
    b, t, _ = h.shape
    pos_ids = torch.arange(t, device=h.device)
    table = w("wavlm.encoder.layers.0.attention.rel_attn_embed.weight")
    bias = table[bucket(pos_ids[None, :] - pos_ids[:, None], cfg["num_buckets"],
                        cfg["max_bucket_distance"])].permute(2, 0, 1)  # (heads, T, T)
    for i in range(cfg["num_hidden_layers"]):
        layer = f"wavlm.encoder.layers.{i}"
        att = f"{layer}.attention"
        u = ln(h, f"{layer}.layer_norm")

        def split(name):
            return linear(u, f"{att}.{name}").view(b, t, heads, hd).transpose(1, 2)

        q, kk, vv = split("q_proj"), split("k_proj"), split("v_proj")
        g = u.view(b, t, heads, hd) @ w(f"{att}.gru_rel_pos_linear.weight").t() + w(
            f"{att}.gru_rel_pos_linear.bias")
        g = torch.sigmoid(g.view(b, t, heads, 2, _GATE // 2).sum(-1))
        const = w(f"{att}.gru_rel_pos_const").view(heads)
        gate = (g[..., 0] * (g[..., 1] * const - 1.0) + 2.0).transpose(1, 2)  # (B, heads, T)
        scores = r(q @ kk.transpose(-1, -2)) * (1.0 / math.sqrt(hd)) + gate[..., None] * bias
        probs = _drop(torch.softmax(scores, -1), draws, cfg["attention_dropout"], train)
        ctx = r(r(probs) @ vv).transpose(1, 2).reshape(b, t, -1)
        h = h + _drop(linear(ctx, f"{att}.out_proj"), draws, cfg["hidden_dropout"], train)
        ff = f"{layer}.feed_forward"
        a = F.gelu(linear(ln(h, f"{layer}.final_layer_norm"), f"{ff}.intermediate_dense"))
        a = _drop(a, draws, cfg["activation_dropout"], train)
        h = h + _drop(linear(a, f"{ff}.output_dense"), draws, cfg["hidden_dropout"], train)
    h = ln(h, "wavlm.encoder.layer_norm")
    z = (h @ w("projector.weight").t() + w("projector.bias")).mean(1)
    return z @ w("classifier.weight").t() + w("classifier.bias")


def grl_forward(p: dict, x: torch.Tensor, cfg: dict, eps: torch.Tensor, draws, prec=F32):
    """(emotion logits, gender logits) of the cloak + GRL game under one
    noise draw ``eps`` (1, win_len, hop): the frozen emotion backbone in
    eval mode, the gender backbone in train mode behind the reversal."""
    noised = (x[:, 0] + (p["noise.locs"] + R.noise_scales(p, cfg) * eps))[:, None]
    emo = backbone_forward(p, noised, cfg, "emotion", False, prefix="emotion_backbone.",
                           prec=prec)
    gen = backbone_forward(p, R._Reverse.apply(noised, cfg["grl_lambda"]), cfg, "gender", True,
                           draws, "gender_backbone.", prec)
    return emo, gen


def grl_loss(p, x, labels_emo, labels_gen, weights, cfg, eps, draws, prec=F32):
    emo, gen = grl_forward(p, x, cfg, eps, draws, prec)
    loss = (R.weighted_ce(emo, labels_emo, weights)
            + cfg["gender_lambda"] * R.weighted_ce(gen, labels_gen, weights))
    return loss - cfg["scale_lambda"] * torch.log(R.noise_scales(p, cfg).mean())


def baseline_loss(p, x, labels, weights, cfg, draws, prec=F32):
    return R.weighted_ce(backbone_forward(p, x, cfg, cfg["pred"], True, draws, prec=prec),
                         labels, weights)


# -- FLOPs --------------------------------------------------------------------

def frames(cfg: dict) -> list:
    """Frames after each conv of the feature encoder, on one window."""
    n, out = cfg["win_len"] * cfg["hop"], []
    for k, s in zip(cfg["conv_kernel"], cfg["conv_stride"]):
        n = (n - k) // s + 1
        out.append(n)
    return out


def layer_flops(cfg: dict) -> dict:
    """FLOPs of one forward of a backbone on one window, by part: the
    multiply-adds (2 each) of the convolutions, the projections, the
    attention scores and values, the gate's linear, the FFN and the head.
    Elementwise work (LayerNorm, GELU, softmax, the bias, dropout, the mean)
    is left out."""
    h, inter = cfg["hidden_size"], cfg["intermediate_size"]
    heads = cfg["num_attention_heads"]
    n_frames, c_in, out = frames(cfg), 1, {}
    for i, (c, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        out[f"conv{i}"] = 2.0 * n_frames[i] * c * c_in * k
        c_in = c
    t = n_frames[-1]
    out["projection"] = 2.0 * t * c_in * h
    out["pos_conv"] = (2.0 * t * h * (h // cfg["num_conv_pos_embedding_groups"])
                       * cfg["num_conv_pos_embeddings"])
    per_layer = (2.0 * t * 4 * h * h + 2.0 * 2 * t * t * h + 2.0 * t * heads * (h // heads) * _GATE
                 + 2.0 * 2 * t * h * inter)
    for i in range(cfg["num_hidden_layers"]):
        out[f"layer{i}"] = per_layer
    n_cls = cfg["classes"][cfg.get("pred", "emotion")]
    p_size = cfg["classifier_proj_size"]
    out["head"] = 2.0 * t * h * p_size + 2.0 * p_size * n_cls
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


def counters() -> dict:
    """No kernel of the program's own on this path."""
    return {}
