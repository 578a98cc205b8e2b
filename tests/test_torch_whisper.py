"""Whisper-large-v3's encoder (``sept_tpu_torch/models/whisper.py``), its
frontend (``device_ingest(frontend="whisper")``) and the mel kernel's
Slaney bank, against the benchmark's plain reference
(``gpu_bench/reference/whisper.py``) and Hugging Face's own Whisper, on the
CPU.

The JAX package has no Whisper, so the plain torch reference is what the
port is held to; ``transformers``' randomly initialised
``WhisperForAudioClassification`` (no download) and its feature extractor
are a second, independent statement of the same equations.  The tiny size
(the family's ``TINY``: 2 layers, d 64, 4 heads, 16 mels, 80 frames in and
40 after the stride-2 convolution) keeps every kind of layer.  Weights are
the benchmark's seeded ones (``harness/weights.py``).

The test marked ``card`` runs the cell's shape on the H100 (``python -m
pytest tests/test_torch_whisper.py --noconftest -m card -q``; the suite's
conftest imports JAX, which the card's machine does not have)."""

import json
import os
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_bench.harness.weights import make_weights
from gpu_bench.reference import whisper as W
from sept_tpu_torch.data.device_pipeline import device_ingest
from sept_tpu_torch.models import CloakedModelGRL, build_backbone
from sept_tpu_torch.models.backbone import DropoutDraws
from sept_tpu_torch.models.whisper import sinusoids
from sept_tpu_torch.ops import frontend as FE
from sept_tpu_torch.ops import mel as M
from sept_tpu_torch.ops.attention import self_attention
from sept_tpu_torch.train.config import preset
from sept_tpu_torch.train.optim import make_cloak_optimizer
from sept_tpu_torch.train.steps import grl_loss, init_state, make_cloak_epoch_runner, scale_reg

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED_CFG = json.loads(
    (ROOT / "gpu_bench" / "configs" / "whisper_large_v3_cloak_grl.json").read_text())
GRL = {**PUBLISHED_CFG, **W.TINY}
BASE = {**GRL, "task": "baseline"}
DTYPES = {"float32": (torch.float32, W.F32), "bfloat16": (torch.bfloat16, W.BF16)}
# float32 on both sides, the same products summed in other orders (q, k
# and v as one product, the convolutions as products of unfolded frames in
# the program): a few float32 units of the unit-scale logits (2e-7 read)
F32_TOL = 1e-5
# bf16 operands and stored outputs at the same places on both sides: where a
# float32 sum lands next to a rounding boundary it may round the other way,
# one bf16 unit, and the layers carry that on (the program read 2.4e-7 on
# the CPU, whose bf16 products sum in float32 as the reference's do); the
# float32 forward and the float8 control lie 4.9e-3 and 6e-2 off
# (test_bf16_tolerance_is_tight)
BF16_TOL = 1e-3
# a leaf's gradient or change in float32 on both sides, against the larger
# of its reference norm and the median leaf's: sums over the batch's frames
# in other orders, with room for leaves whose terms cancel
LEAF_TOL = 1e-4
# the same in bf16: the gradients pass through the bf16 roundings of both
# sides, which agree to a bf16 unit where a sum lands on a boundary; the
# float8 control reads far above (test_bf16_gradients_follow_the_reference)
BF16_LEAF_TOL = 2e-2


def _backbone(cfg, pred, dtype=torch.float32):
    return build_backbone(pred=pred, compute_dtype=dtype, **W.backbone_kwargs(cfg))


def _windows(seed, n=3, cfg=GRL):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 1, cfg["win_len"], cfg["num_mel_bins"]), generator=g)


def test_sinusoids_are_whispers():
    """Hugging Face's table: ``[sin | cos]`` at log(10000) / 639
    increments at the published width."""
    got = sinusoids(1500, 1280)
    inv = torch.exp(-(np.log(10000.0) / 639) * torch.arange(640))
    t = torch.arange(1500)[:, None] * inv[None, :]
    assert torch.equal(got, torch.cat([t.sin(), t.cos()], 1))
    assert torch.equal(W.sinusoids(1500, 1280), got)


def test_leaves_name_the_state_dict():
    model = CloakedModelGRL(_backbone(GRL, "emotion"), _backbone(GRL, "gender"),
                            win_len=GRL["win_len"], n_feats=GRL["num_mel_bins"])
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(shape) for k, (shape, _) in W.leaves(GRL).items()}
    assert "emotion_backbone.encoder.layers.0.self_attn.k_proj.bias" not in got


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_logits_follow_the_reference(dtype, train, seed):
    cd, prec = DTYPES[dtype]
    w0 = make_weights(BASE, W, seed, "cpu")
    model = _backbone(BASE, "emotion", cd)
    model.load_state_dict(w0)
    model.train(train)
    x = _windows(seed)
    with torch.no_grad():
        got = model(x, dropout=DropoutDraws(torch.Generator().manual_seed(seed)))
        want = W.backbone_forward(w0, x, BASE, "emotion", train, prec=prec)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    torch.testing.assert_close(got, want, rtol=0.0, atol=tol)
    assert float(want.std()) > 0.1  # the logits differ from window to window


class _GeluSpy:
    """``torch.nn.functional`` for the model module, whose ``gelu`` keeps a
    weak reference to each of its outputs."""

    def __init__(self):
        self.outputs = []

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    def gelu(self, a):
        out = torch.nn.functional.gelu(a)
        self.outputs.append(weakref.ref(out))
        return out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ffn_recomputes_its_gelu_bit_for_bit(dtype, monkeypatch):
    """fc2's backward recomputes the GELU rather than keep it: every
    gradient equals, bit for bit, that of the plain ``fc2(GELU(a))``, and
    after the forward no FFN GELU output is alive, where the plain product
    keeps each layer's."""
    from sept_tpu_torch.models import whisper as model_mod

    cd, _ = DTYPES[dtype]
    model = _backbone(BASE, "emotion", cd)
    model.load_state_dict(make_weights(BASE, W, 11, "cpu"))
    x0 = _windows(11, n=2)
    plain = lambda a, lin, cd: model_mod._linear(model_mod.tf.gelu(a), lin, cd)  # noqa: E731
    grads, alive = {}, {}
    for name, helper in (("recomputed", model_mod._gelu_linear), ("plain", plain)):
        spy = _GeluSpy()
        monkeypatch.setattr(model_mod, "tf", spy)
        monkeypatch.setattr(model_mod, "_gelu_linear", helper)
        x = x0.clone().requires_grad_()
        out = model(x)
        alive[name] = sum(r() is not None and r().shape[-1] == BASE["encoder_ffn_dim"]
                          for r in spy.outputs)
        out.sum().backward()
        grads[name] = {"x": x.grad, **{k: v.grad.clone() for k, v in model.named_parameters()}}
        model.zero_grad(set_to_none=True)
    want, got = grads["plain"], grads["recomputed"]
    assert all(torch.equal(got[k], want[k]) for k in want), [
        k for k in want if not torch.equal(got[k], want[k])]
    assert alive == {"recomputed": 0, "plain": BASE["encoder_layers"]}


def test_bf16_tolerance_is_tight():
    """The bf16 program against the bf16 reference, beside the float32
    reference and the float8 control: only the first is within BF16_TOL."""
    gaps = {"float32": [], "fp8": [], "program": []}
    for seed in (3, 4, 5):
        w0 = make_weights(BASE, W, seed, "cpu")
        model = _backbone(BASE, "emotion", torch.bfloat16).eval()
        model.load_state_dict(w0)
        x = _windows(seed)
        with torch.no_grad():
            ref = W.backbone_forward(w0, x, BASE, "emotion", False, prec=W.BF16)
            for name, got in (("float32", W.backbone_forward(w0, x, BASE, "emotion", False)),
                              ("fp8", W.backbone_forward(w0, x, BASE, "emotion", False,
                                                         prec=W.FP8)),
                              ("program", model(x))):
                gaps[name].append(float((got - ref).abs().max()))
    assert max(gaps["program"]) <= BF16_TOL
    assert min(gaps["float32"]) > 2 * BF16_TOL and min(gaps["fp8"]) > 20 * BF16_TOL, gaps


def _cloak(cfg, w0, dtype=torch.float32):
    model = CloakedModelGRL(_backbone(cfg, "emotion", dtype), _backbone(cfg, "gender", dtype),
                            grl_lambda=cfg["grl_lambda"], win_len=cfg["win_len"],
                            n_feats=cfg["num_mel_bins"], min_scale=cfg["noise_min_scale"],
                            max_scale=cfg["noise_max_scale"])
    model.load_state_dict(w0)
    return model


def _gap(a: dict, b: dict) -> dict:
    """Per leaf, the norm of a - b over the larger of b's norm and the
    median leaf's (the benchmark's rule, harness drivers/train.py)."""
    norms = {k: float(v.norm()) for k, v in b.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: float((a[k] - b[k]).norm()) / max(norms[k], med, 1e-30) for k in b}


def _grl_grads(seed, dtype, prec):
    """One GRL loss with the scale regularizer through ``CloakedModelGRL``
    and through the reference: (loss, ref loss, grads, ref grads, control
    grads) by leaf, the frozen emotion backbone's included."""
    w0 = make_weights(GRL, W, seed, "cpu")
    model = _cloak(GRL, w0, dtype).train()
    n = 3
    x = _windows(seed + 1, n)
    g = torch.Generator().manual_seed(seed + 2)
    le, lg = torch.randint(0, 4, (n,), generator=g), torch.randint(0, 2, (n,), generator=g)
    wts = torch.ones(n)
    gen = torch.Generator().manual_seed(seed)
    eps = model.noise.draw_eps(gen)
    loss, _, _ = grl_loss(model, x, le, lg, wts, eps, None, "mean", False,
                          GRL["gender_lambda"], DropoutDraws(gen), None)
    loss = scale_reg(model, loss, GRL["scale_lambda"], True)
    loss.backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    out = []
    for pr in (prec, W.FP8):
        p = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
        draws = W.Draws(torch.Generator().manual_seed(seed))
        ref_eps = GRL["eps_std"] * draws.normal(W.noise_shape(GRL))
        ref_loss = W.grl_loss(p, x, le, lg, wts, GRL, ref_eps, draws, pr)
        names = sorted(p)
        out.append((ref_loss, dict(zip(names, torch.autograd.grad(ref_loss,
                                                                  [p[k] for k in names])))))
    return loss, out[0][0], got, out[0][1], out[1][1]


@pytest.mark.parametrize("seed", [7, 2**31 + 3])
def test_every_leaf_gradient_through_the_cloak(seed):
    """float32: the loss and every leaf's gradient, the noise's and both
    backbones', through the reference's window-at-a-time blocks."""
    loss, ref_loss, got, want, _ = _grl_grads(seed, torch.float32, W.F32)
    assert abs(float(loss.detach()) - float(ref_loss.detach())) <= F32_TOL * abs(
        float(ref_loss.detach()))
    assert got.keys() == want.keys()
    gaps = _gap(got, want)
    assert max(gaps.values()) <= LEAF_TOL, max(gaps.items(), key=lambda kv: kv[1])
    assert all(float(v.norm()) > 0 for v in want.values())


@pytest.mark.parametrize("seed", [7, 2**31 + 3])
def test_bf16_gradients_follow_the_reference(seed):
    """bf16: the loss within BF16_TOL of its size and the gradients of the
    noise and of the gender backbone within BF16_LEAF_TOL, where the
    float8 control's gradients lie further off."""
    loss, ref_loss, got, want, control = _grl_grads(seed, torch.bfloat16, W.BF16)
    assert abs(float(loss.detach()) - float(ref_loss.detach())) <= BF16_TOL * abs(
        float(ref_loss.detach()))
    keys = [k for k in want if not k.startswith("emotion_backbone.")]
    gaps = _gap({k: got[k] for k in keys}, {k: want[k] for k in keys})
    assert max(gaps.values()) <= BF16_LEAF_TOL, max(gaps.items(), key=lambda kv: kv[1])
    ctrl = _gap({k: control[k] for k in keys}, {k: want[k] for k in keys})
    assert max(ctrl.values()) > 2 * BF16_LEAF_TOL


def test_one_epoch_of_the_cloak_runner():
    """``make_cloak_epoch_runner`` (eager on the CPU: the same step a card
    captures) over 3 batches against the reference's SGD steps from the
    same weights and generator seed: each loss, and each leaf's change; the
    frozen emotion backbone does not move."""
    cfg, seed, n_batches, bs = GRL, 11, 3, 2
    w0 = make_weights(cfg, W, seed, "cpu")
    model = _cloak(cfg, w0)
    opt = cfg["optimizer"]
    exp = preset(opt["preset"], learning_rate=opt["learning_rate"], momentum=opt["momentum"],
                 weight_decay=opt["weight_decay"], batch_size=bs)
    trainable = tuple(cfg["trainable"])
    state = init_state(model, make_cloak_optimizer(exp, n_batches, model, trainable), seed,
                       "cpu")
    n = n_batches * bs
    x = _windows(seed + 1, n)[:, 0]
    g = torch.Generator().manual_seed(seed + 2)
    le, lg = torch.randint(0, 4, (n,), generator=g), torch.randint(0, 2, (n,), generator=g)
    wts = torch.ones(n)
    runner = make_cloak_epoch_runner(cfg["scale_lambda"], cfg["gender_lambda"], grl=True)
    _, losses, _, _ = runner(state, x, le, lg, wts, torch.arange(n), None, n_batches=n_batches,
                             batch_size=bs)
    assert runner.eager_steps == n_batches

    p = {k: v.clone().requires_grad_(k.split(".")[0] in trainable) for k, v in w0.items()}
    names = sorted(k for k in p if p[k].requires_grad)
    draws = W.Draws(torch.Generator().manual_seed(seed))
    bufs, ref_losses = {}, []
    for i in range(n_batches):
        rows = slice(i * bs, (i + 1) * bs)
        eps = cfg["eps_std"] * draws.normal(W.noise_shape(cfg))
        loss = W.grl_loss(p, x[rows, None], le[rows], lg[rows], wts[rows], cfg, eps, draws)
        grads = dict(zip(names, torch.autograd.grad(loss, [p[k] for k in names])))
        W.sgd_step(p, grads, bufs, opt, cfg)
        ref_losses.append(float(loss.detach()))
    torch.testing.assert_close(losses, torch.tensor(ref_losses), rtol=F32_TOL, atol=0.0)
    params = dict(model.named_parameters())
    got = {k: params[k].detach() - w0[k] for k in names}
    want = {k: p[k].detach() - w0[k] for k in names}
    gaps = _gap(got, want)
    assert max(gaps.values()) <= LEAF_TOL, max(gaps.items(), key=lambda kv: kv[1])
    for k, v in params.items():
        if k.startswith("emotion_backbone."):
            assert torch.equal(v.detach(), w0[k]), k


# -- Hugging Face's Whisper ---------------------------------------------------


def _transformers():
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    return pytest.importorskip("transformers")


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_logits_follow_transformers(seed):
    """The float32 port with a random ``WhisperForAudioClassification``'s
    weights (its own initialisation, no download; eager attention) gives
    that model's logits: the same equations stated twice."""
    tr = _transformers()
    torch.manual_seed(seed % 2**31)
    hf_cfg = tr.WhisperConfig(
        d_model=GRL["d_model"], encoder_layers=GRL["encoder_layers"],
        encoder_attention_heads=GRL["encoder_attention_heads"],
        encoder_ffn_dim=GRL["encoder_ffn_dim"], num_mel_bins=GRL["num_mel_bins"],
        max_source_positions=GRL["max_source_positions"],
        classifier_proj_size=GRL["classifier_proj_size"], num_labels=4, decoder_layers=1,
        decoder_attention_heads=4, decoder_ffn_dim=32, attn_implementation="eager")
    hf = tr.WhisperForAudioClassification(hf_cfg).eval()
    model = _backbone(BASE, "emotion").eval()
    state = {k: v for k, v in hf.state_dict().items() if k != "encoder.embed_positions.weight"}
    model.load_state_dict(state)
    torch.testing.assert_close(hf.state_dict()["encoder.embed_positions.weight"],
                               model.encoder.embed_positions, rtol=0.0, atol=1e-6)
    x = _windows(seed)
    with torch.no_grad():
        want = hf(x[:, 0].transpose(1, 2)).logits
        got = model(x)
    torch.testing.assert_close(got, want, rtol=0.0, atol=F32_TOL)


def _waves(seed, lengths):
    rng = np.random.default_rng(seed)
    t = np.arange(max(lengths)) / 16000.0
    out = []
    for n in lengths:
        f = rng.uniform(100, 2000)
        w = 0.3 * np.sin(2 * np.pi * f * t[:n]) + 0.05 * rng.standard_normal(n)
        out.append((w * 20000).astype(np.int16))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_whisper_frontend_follows_the_feature_extractor(seed):
    """``device_ingest(frontend="whisper")`` against ``transformers``'
    ``WhisperFeatureExtractor`` (its torch path, the padding its call does:
    zeros to n_samples, a longer clip cut) and the reference's float64
    windows: a clip shorter, one as long as and one longer than the window;
    f32 against the float64 STFT: a few float32 units of the unit-scale
    features."""
    tr = _transformers()
    cfg, size = GRL, GRL["n_samples"]
    waves = _waves(seed, (10_080, size, size + 1_500))
    ds = device_ingest(waves, np.zeros(3), np.arange(3), np.arange(3) % 2, frontend="whisper",
                       device="cpu", **W.ingest_kwargs(cfg))
    assert ds.windows.shape == (3, cfg["win_len"], cfg["num_mel_bins"])
    assert ds.weight.tolist() == [1.0] * 3 and ds.labels_emo.tolist() == [0, 1, 2]
    fe = tr.WhisperFeatureExtractor(feature_size=cfg["num_mel_bins"], n_samples=size,
                                    chunk_length=size / 16000)
    stacked = np.stack([np.pad(w, (0, size + 1_500 - len(w))) for w in waves])
    ref = W.windows(torch.as_tensor(stacked), None, range(3), cfg)
    for i, w in enumerate(waves):
        x = np.pad(w.astype(np.float32) / 32768.0, (0, max(0, size - len(w))))[:size]
        want = torch.as_tensor(fe._torch_extract_fbank_features(x[None], "cpu")[0]).T
        torch.testing.assert_close(ds.windows[i], want.float(), rtol=0.0, atol=2e-6)
        torch.testing.assert_close(ref[i], want.double(), rtol=0.0, atol=2e-6)


def test_whisper_frontend_refuses_float_waves():
    with pytest.raises(ValueError, match="int16"):
        device_ingest([np.zeros(100, np.float32)], np.zeros(1), np.zeros(1), np.zeros(1),
                      frontend="whisper", device="cpu", **W.ingest_kwargs(GRL))


# -- the mel kernel's tables --------------------------------------------------


def _sparse_bank_before(n_fft, n_mels):
    """``ops/mel.py::sparse_bank`` as it stood with the HTK bank alone."""
    fb = FE.melscale_fbanks(n_fft // 2 + 1, 0.0, 8000.0, n_mels, 16000)
    index = np.zeros((3, n_mels), np.int32)
    weights = []
    for m in range(n_mels):
        nz = np.nonzero(fb[:, m])[0]
        first, count = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if len(nz) else (0, 0)
        index[:, m] = first, count, sum(len(w) for w in weights)
        weights.append(fb[first:first + count, m])
    return index, np.concatenate(weights).astype(np.float32)


@pytest.mark.parametrize("n_fft,n_mels", [(800, 128), (400, 128), (1600, 40), (400, 80)])
def test_default_bank_is_unchanged(n_fft, n_mels):
    index, weights = M.sparse_bank(n_fft, n_mels)
    before = _sparse_bank_before(n_fft, n_mels)
    assert np.array_equal(index, before[0]) and np.array_equal(weights, before[1])
    assert weights.tobytes() == before[1].tobytes()


@pytest.mark.parametrize("n_mels", [128, 80, 16])
def test_slaney_bank_is_whispers(n_mels):
    """The kernel's sparse Slaney table holds the dense table of
    ``frontend.melscale_fbanks(..., mel_scale="slaney", norm="slaney")``
    exactly, which is the reference module's float64 bank rounded."""
    dense = FE.melscale_fbanks(201, 0.0, 8000.0, n_mels, 16000, norm="slaney",
                               mel_scale="slaney")
    index, weights = M.sparse_bank(400, n_mels, "slaney", "slaney")
    rebuilt = np.zeros_like(dense)
    for m in range(n_mels):
        first, count, off = index[:, m]
        rebuilt[first:first + count, m] = weights[off:off + count]
    assert np.array_equal(rebuilt, dense)
    ref = W.slaney_bank(400, n_mels).numpy()
    np.testing.assert_allclose(dense, ref, rtol=1e-6, atol=1e-9)
    assert not np.array_equal(dense, FE.melscale_fbanks(201, 0.0, 8000.0, n_mels, 16000))


def test_bf16_mel_refuses_the_slaney_bank():
    with pytest.raises(ValueError, match="HTK"):
        M.mel_db(torch.zeros(1, 1200), 3, 400, 160, 16, bf16=True, mel_scale="slaney",
                 norm="slaney")


# -- sizes --------------------------------------------------------------------


def test_published_widths_pinned():
    """At the published widths: 635.05 M trainable parameters in the
    encoder (conv1 0.49 M, conv2 4.92 M, 32 x 19.68 M, the final
    LayerNorm), 0.33 M in the head; the state dict the reference's leaves
    name; and F = 2.2747 TFLOP a 30 s window (conv1 2.95 GFLOP, conv2
    14.75, each of the 32 layers 70.50 of which the attention core 11.52,
    the head 0.98)."""
    cfg = PUBLISHED_CFG
    with torch.device("meta"):
        model = _backbone(cfg, "emotion", torch.bfloat16)
    params = dict(model.named_parameters())
    enc = sum(p.numel() for k, p in params.items() if k.startswith("encoder."))
    head = sum(p.numel() for k, p in params.items() if not k.startswith("encoder."))
    assert enc == pytest.approx(635.05e6, rel=1e-5)
    assert head == pytest.approx(0.33e6, rel=1e-2)
    assert model.encoder.embed_positions.shape == (1500, 1280)
    leaves = W.leaves({**cfg, "task": "baseline"})
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(s) for k, (s, _) in leaves.items()}
    parts = W.layer_flops(cfg)
    assert parts["conv1"] == pytest.approx(2.949e9, rel=1e-3)
    assert parts["conv2"] == pytest.approx(14.75e9, rel=1e-3)
    assert parts["layer0"] == pytest.approx(70.50e9, rel=1e-3)
    core = 2 * 2 * 1500 * 1500 * 1280
    assert core == pytest.approx(11.52e9, rel=1e-3)
    assert parts["head"] == pytest.approx(0.983e9, rel=1e-3)
    assert W.forward_flops(cfg) == pytest.approx(2.2747e12, rel=1e-4)
    assert W.train_flops_per_window(cfg) == pytest.approx(5 * 2.2747e12, rel=1e-4)
    assert W.attention_calls(cfg) == (64, 64)
    # 64 forward calls of 92.2 GFLOP and 64 backward of 184.3 at 989 TFLOP/s
    assert W.attention_core_least_s(cfg, 8) == pytest.approx(
        64 * (92.16e9 + 184.32e9) / 989e12, rel=1e-4)


def test_refusals():
    with pytest.raises(ValueError, match="global"):
        _backbone(BASE, "emotion")(_windows(0, 1), global_feature=torch.zeros(1, 88))
    with pytest.raises(ValueError, match="frames"):
        _backbone(BASE, "emotion")(torch.zeros(1, 1, 60, BASE["num_mel_bins"]))
    with pytest.raises(ValueError, match="pred"):
        _backbone(BASE, "multitask")


# -- the card -----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_card_one_published_grl_step(card):
    """One GRL step of the cell's shape on the card (batch 8 at 3,000
    frames, both backbones at the published widths, bf16): 64 streaming
    attention forwards and 64 backwards, a finite loss, every trainable
    leaf of the gender backbone moved, and the peak memory under the card's
    80 GB."""
    from sept_tpu_torch.train.steps import make_cloak_grl_step

    cfg = PUBLISHED_CFG
    torch.manual_seed(0)
    model = CloakedModelGRL(*(build_backbone(pred=p, compute_dtype=torch.bfloat16,
                                             **W.backbone_kwargs(cfg))
                              for p in ("emotion", "gender")),
                            win_len=cfg["win_len"], n_feats=cfg["num_mel_bins"])
    exp = preset("cloak_grl", batch_size=8)
    state = init_state(model, make_cloak_optimizer(exp, 4, model, tuple(cfg["trainable"])), 5,
                       card)
    g = torch.Generator().manual_seed(2)
    batch = {"spec": torch.randn((8, 1, 3000, 128), generator=g).to(card),
             "labels_emo": torch.arange(8, device=card) % 4,
             "labels_gen": torch.arange(8, device=card) % 2,
             "weight": torch.ones(8, device=card)}
    before = {k: p.detach().clone() for k, p in model.named_parameters()
              if k.startswith("gender_backbone.encoder.layers.31")}
    self_attention.launches = self_attention.launches_bwd = 0
    torch.cuda.reset_peak_memory_stats(card)
    _, metrics = make_cloak_grl_step(0.1, 0.1)(state, batch)
    torch.cuda.synchronize()
    assert (self_attention.launches, self_attention.launches_bwd) == (64, 64)
    assert bool(torch.isfinite(metrics["loss"]))
    params = dict(model.named_parameters())
    assert all(not torch.equal(params[k], v) for k, v in before.items())
    assert torch.cuda.max_memory_allocated(card) < 80e9
