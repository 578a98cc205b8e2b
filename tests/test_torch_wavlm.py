"""WavLM-Large (``sept_tpu_torch/models/wavlm.py``) against the benchmark's
plain reference of it (``gpu_bench/reference/wavlm.py``), on the CPU.

The JAX package has no WavLM, so the plain torch reference is what the port
is held to.  The tiny size keeps every kind of layer: the seven stem
convolutions at the published kernels and strides (a 7,680-sample window,
23 frames), two pre-LN layers, the bias table with exact and log-spaced
buckets (32 buckets up to distance 40), the gate, and the grouped
positional convolution under weight norm (k 8, 4 groups).  Weights are the
benchmark's seeded ones (``harness/weights.py``); dropout and noise draws
come from one seeded generator on each side, in the program's order."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_bench.harness.weights import make_weights
from gpu_bench.reference import wavlm as W
from sept_tpu_torch.data.device_pipeline import device_ingest
from sept_tpu_torch.models import CloakedModelGRL, build_backbone
from sept_tpu_torch.models.backbone import DropoutDraws
from sept_tpu_torch.models.wavlm import relative_position_bucket
from sept_tpu_torch.train.config import preset
from sept_tpu_torch.train.optim import make_cloak_optimizer
from sept_tpu_torch.train.steps import grl_loss, init_state, make_cloak_epoch_runner, scale_reg

ROOT = Path(__file__).resolve().parents[1]
PUBLISHED_CFG = json.loads(
    (ROOT / "gpu_bench" / "configs" / "wavlm_large_cloak_grl.json").read_text())
GRL = {**PUBLISHED_CFG, **W.TINY}
BASE = {**GRL, "task": "baseline"}
DTYPES = {"float32": (torch.float32, W.F32), "bfloat16": (torch.bfloat16, W.BF16)}
# float32 on both sides, the same products but summed in other orders
# (q, k, v as one product in the program): a few float32 units
F32_TOL = 1e-5
# bf16 operands and stored outputs on both sides: where a sum lands next to a
# rounding boundary it rounds the other way, one bf16 unit (2^-8 relative),
# and the two layers carry that on (at most 1.6e-3 on 3 seeds); the float32
# forward and the float8 control lie 2.4x and 35x further off than the
# limit (test_bf16_tolerance_is_tight)
BF16_TOL = 2.5e-3
# a leaf's gradient or change in float32 on both sides, against the larger of
# its reference norm and the median leaf's: sums over the batch's frames in
# other orders: 9e-7 of the larger norm for a gradient, 9e-6 for the change
# after 3 steps (read on the CPU), with room for leaves whose terms cancel
LEAF_TOL = 1e-4


def _backbone(cfg, pred, dtype=torch.float32):
    return build_backbone(pred=pred, compute_dtype=dtype, **W.backbone_kwargs(cfg))


def _windows(seed, n=4, cfg=GRL):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 1, cfg["win_len"], cfg["hop"]), generator=g)


def test_bucket_table():
    """The published bucketing (320 buckets, max distance 800): distances
    under 80 exact, then log-spaced, positive distances (key after query)
    in the upper half, everything from 800 on in a direction's last
    bucket.  98 is the farthest distance at 99 frames."""
    rel = torch.tensor([0, 1, -1, 79, -79, 80, -80, 81, -81, 98, -98, 799, -799, 800, -800,
                        1000, -1000])
    want = torch.tensor([0, 161, 1, 239, 79, 240, 80, 240, 80, 247, 87, 319, 159, 319, 159,
                         319, 159])
    assert torch.equal(relative_position_bucket(rel, 320, 800), want)
    assert torch.equal(W.bucket(rel, 320, 800), want)
    # 80 + floor(ln(98 / 80) / ln(10) * 80) = 80 + floor(7.05)
    assert 80 + math.floor(math.log(98 / 80) / math.log(10) * 80) == 87


def test_tiny_size_reaches_the_log_buckets():
    t = W.frames(GRL)[-1]
    assert W.frames(GRL) == [1535, 767, 383, 191, 95, 47, 23]
    rel = torch.arange(-(t - 1), t)
    got = W.bucket(rel, GRL["num_buckets"], GRL["max_bucket_distance"])
    assert (rel.abs() >= GRL["num_buckets"] // 4).any()
    assert len(set(got.tolist())) < len(rel)  # some distances share a bucket


@pytest.mark.parametrize("with_bias", [False, True])
def test_leaves_name_the_state_dict(with_bias):
    cfg = {**GRL, "conv_bias": with_bias}
    model = CloakedModelGRL(_backbone(cfg, "emotion"), _backbone(cfg, "gender"),
                            win_len=cfg["win_len"], n_feats=cfg["hop"])
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(shape) for k, (shape, _) in W.leaves(cfg).items()}


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
    draws = DropoutDraws(torch.Generator().manual_seed(seed)) if train else None
    ref_draws = W.Draws(torch.Generator().manual_seed(seed)) if train else None
    with torch.no_grad():
        got = model(x, dropout=draws)
        want = W.backbone_forward(w0, x, BASE, "emotion", train, ref_draws, prec=prec)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        torch.testing.assert_close(got, want, rtol=0.0, atol=BF16_TOL)
    assert float(want.std()) > 0.1  # the logits differ from window to window


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
    assert min(gaps["float32"]) > BF16_TOL and min(gaps["fp8"]) > 10 * BF16_TOL, gaps


def _cloak(cfg, w0):
    model = CloakedModelGRL(_backbone(cfg, "emotion"), _backbone(cfg, "gender"),
                            grl_lambda=cfg["grl_lambda"], win_len=cfg["win_len"],
                            n_feats=cfg["hop"], min_scale=cfg["noise_min_scale"],
                            max_scale=cfg["noise_max_scale"])
    model.load_state_dict(w0)
    return model


def _gap(a: dict, b: dict) -> dict:
    """Per leaf, the norm of a - b over the larger of b's norm and the
    median leaf's (the benchmark's rule, harness drivers/train.py)."""
    norms = {k: float(v.norm()) for k, v in b.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {k: float((a[k] - b[k]).norm()) / max(norms[k], med, 1e-30) for k in b}


@pytest.mark.parametrize("seed", [7, 2**31 + 3])
def test_every_leaf_gradient_through_the_cloak(seed):
    """One train-mode GRL loss, the scale regularizer with it, through
    ``CloakedModelGRL``: every leaf's gradient, the frozen emotion
    backbone's included (the optimizer freezes it, not the model)."""
    w0 = make_weights(GRL, W, seed, "cpu")
    model = _cloak(GRL, w0).train()
    n = 4
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

    p = {k: v.clone().requires_grad_(True) for k, v in w0.items()}
    draws = W.Draws(torch.Generator().manual_seed(seed))
    ref_eps = GRL["eps_std"] * draws.normal(W.noise_shape(GRL))
    ref_loss = W.grl_loss(p, x, le, lg, wts, GRL, ref_eps, draws)
    names = sorted(p)
    want = dict(zip(names, torch.autograd.grad(ref_loss, [p[k] for k in names])))
    assert abs(float(loss.detach()) - float(ref_loss.detach())) <= F32_TOL * abs(float(
        ref_loss.detach()))
    assert got.keys() == want.keys()
    gaps = _gap(got, want)
    assert max(gaps.values()) <= LEAF_TOL, max(gaps.items(), key=lambda kv: kv[1])
    assert all(float(v.norm()) > 0 for v in want.values())


def test_one_epoch_of_the_cloak_runner():
    """``make_cloak_epoch_runner`` (eager on the CPU: the same step a card
    captures) over 3 batches against the reference's SGD steps from the
    same weights and generator seed: each loss, and each leaf's change; the
    frozen emotion backbone does not move."""
    cfg, seed, n_batches, bs = GRL, 11, 3, 4
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


def test_wave_ingest_follows_the_reference_windows():
    """``device_ingest(frontend="wave")``: (win_len, hop) windows every
    shift_len * hop samples of the int16 / 32768 wave, each normalized, as
    the reference's float64 windows (float32 statistics over 7,680 samples:
    a few float32 units)."""
    cfg = GRL
    rng = np.random.default_rng(0)
    n, length = 5, 10_080  # 0.63 s: 2 whole windows of 7,680 samples, stride 1,920
    waves = (rng.standard_normal((n, length)) * 3000).astype(np.int16)
    spk = np.arange(n) % 2
    ds = device_ingest(list(waves), spk, np.zeros(n), np.ones(n), frontend="wave",
                       win_len=cfg["win_len"], shift_len=cfg["shift_len"], device="cpu")
    assert ds.windows.shape == (2 * n, cfg["win_len"], cfg["hop"])
    assert bool((ds.weight == 1).all())
    want = W.windows(torch.as_tensor(waves), torch.as_tensor(spk), range(2 * n), cfg)
    torch.testing.assert_close(ds.windows.double(), want, rtol=0.0, atol=2e-6)
    assert torch.allclose(ds.windows.mean(-1).mean(-1), torch.zeros(2 * n), atol=1e-5)


def test_wave_ingest_weights_and_pads_short_utterances():
    """An utterance shorter than the longest gets weight 0 past its last
    whole window; one shorter than a window is padded with zeros to one."""
    cfg = GRL
    size = cfg["win_len"] * cfg["hop"]
    rng = np.random.default_rng(1)
    waves = [(rng.standard_normal(m) * 1000).astype(np.int16)
             for m in (10_080, size + 100, size - 500)]
    ds = device_ingest(waves, np.zeros(3), np.arange(3), np.arange(3), frontend="wave",
                       win_len=cfg["win_len"], shift_len=cfg["shift_len"], device="cpu")
    assert ds.weight.tolist() == [1.0, 1.0, 1.0, 0.0, 1.0, 0.0]
    assert ds.labels_emo.tolist() == [0, 0, 1, 1, 2, 2]
    tail = ds.windows[4].reshape(-1)[size - 500:]
    assert bool((tail == tail[0]).all())  # the zeros, normalized
    with pytest.raises(ValueError, match="int16"):
        device_ingest([w.astype(np.float32) for w in waves], np.zeros(3), np.zeros(3),
                      np.zeros(3), frontend="wave", device="cpu")


def test_published_widths_pinned():
    """At the published widths: 315.7 M parameters a backbone, the state
    dict the reference's leaves name, and F = 72.42 GFLOP a 32,000-sample
    window (the stem 9.81, projection 0.10, positional conv 1.66, each of
    the 24 layers 2.533, of which the scores and values 1.6%)."""
    cfg = PUBLISHED_CFG
    with torch.device("meta"):
        model = _backbone(cfg, "emotion", torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == pytest.approx(315.7e6, rel=2e-4)
    leaves = W.leaves({**cfg, "task": "baseline"})
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: tuple(s) for k, (s, _) in leaves.items()}
    assert W.frames(cfg)[-1] == 99
    parts = W.layer_flops(cfg)
    assert sum(parts[f"conv{i}"] for i in range(7)) == pytest.approx(9.81e9, rel=1e-3)
    assert parts["projection"] == pytest.approx(0.104e9, rel=1e-2)
    assert parts["pos_conv"] == pytest.approx(1.66e9, rel=1e-3)
    assert parts["layer0"] == pytest.approx(2.533e9, rel=1e-3)
    scores_values = 2 * 2 * 99 * 99 * 1024
    assert scores_values / parts["layer0"] == pytest.approx(0.016, abs=5e-4)
    assert W.forward_flops(cfg) == pytest.approx(72.42e9, rel=1e-4)
    assert W.train_flops_per_window(cfg) == pytest.approx(5 * 72.42e9, rel=1e-4)
    assert W.train_flops_per_window({**cfg, "task": "baseline"}) == pytest.approx(
        3 * 72.42e9, rel=1e-4)


def test_refusals():
    with pytest.raises(ValueError, match="global"):
        _backbone(BASE, "emotion")(_windows(0, 1), global_feature=torch.zeros(1, 88))
    with pytest.raises(ValueError, match="DropoutDraws"):
        _backbone(BASE, "emotion").train()(_windows(0, 1))
    with pytest.raises(ValueError, match="pred"):
        _backbone(BASE, "multitask")
