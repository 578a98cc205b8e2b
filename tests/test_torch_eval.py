"""The port's evaluation (metrics, masks, the sliding vote, the test vote
and the utility-privacy sweep) vs the JAX package's (CPU).

The models are JAX ``Conv2dBiRNN``s at hidden 8 on 60 x 32 windows with
perturbed weights, carried over by sept_tpu_torch.compat.from_jax.  The
sweep's epsilon is JAX's draw (recovered from the noise JAX adds to an
all-zero input) injected into the port.  Tolerances: metrics, masks and the
CSV exact; vote probabilities 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.data.pipeline import SplitArrays as JaxSplit
from sept_tpu.eval import metrics as JM
from sept_tpu.eval import sweep as JS
from sept_tpu.eval.sliding import make_sliding_vote_fn as jax_vote_fn
from sept_tpu.models import CloakNoise as JaxCloakNoise
from sept_tpu.train import ExperimentConfig as JaxConfig
from sept_tpu.train import make_eval_logits_fn as jax_eval_logits_fn
from sept_tpu.train.loop import run_test as jax_run_test
from sept_tpu_torch.compat.from_jax import backbone_state_dict
from sept_tpu_torch.data.pipeline import SplitArrays
from sept_tpu_torch.eval import metrics as M
from sept_tpu_torch.eval import sweep as S
from sept_tpu_torch.eval.sliding import make_sliding_vote_fn, sliding_vote, vote_split
from sept_tpu_torch.models import Conv2dBiRNN
from sept_tpu_torch.train.config import ExperimentConfig
from sept_tpu_torch.train.loop import run_test
from sept_tpu_torch.train.steps import make_eval_logits_fn

from _torch_helpers import jax_backbone

H, WIN, D, SHIFT = 8, 60, 32, 15
# below, at and above one window; 150 frames give 7 windows
LENGTHS = np.array([20, 59, 60, 61, 74, 75, 90, 150, 33, 120], np.int32)
DATASETS = np.array(["iemocap", "crema-d"] * 5, object)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 3, 50)
    pred = rng.integers(0, 5, 50)  # classes 3 and 4 only in the predictions
    assert M.accuracy(truth, pred) == JM.accuracy(truth, pred)
    assert M.uar(truth, pred) == JM.uar(truth, pred)
    np.testing.assert_array_equal(M.confusion(truth, pred), JM.confusion(truth, pred))
    np.testing.assert_array_equal(M.confusion(truth, pred, 6), JM.confusion(truth, pred, 6))
    # a class only in the predictions counts with recall 0; its row is 0
    assert M.uar(np.array([0, 0, 1]), np.array([0, 2, 1])) == pytest.approx((0.5 + 1 + 0) / 3)
    assert not M.confusion(np.array([0, 0, 1]), np.array([0, 2, 1]))[2].any()
    counts = {f"s{k}": int(c) for k, c in enumerate(rng.integers(1, 500, 8))}
    assert M.get_class_weight(counts) == JM.get_class_weight(counts)
    t = {k: rng.integers(0, 4, 20) for k in ("combine", "iemocap", "crema-d", "msp-improv")}
    p = {k: rng.integers(0, 4, 20) for k in t}
    ours, theirs = M.result_dict(t, p, "combine", "emotion", 0.5), JM.result_dict(
        t, p, "combine", "emotion", 0.5)
    for ds in theirs:
        for key in ("acc", "rec", "loss"):
            assert ours[ds][key] == theirs[ds][key]
        np.testing.assert_array_equal(ours[ds]["conf"]["emotion"], theirs[ds]["conf"]["emotion"])


@pytest.mark.parametrize("ratio", [0, 20, 80])
def test_masks_match_jax(ratio):
    rng = np.random.default_rng(ratio)
    scales = rng.uniform(0.01, 10, (WIN, D)).astype(np.float32)
    scales[:5] = scales[0, 0]  # ties at one value
    for ours, theirs in ((S.eval_mask, JS.eval_mask), (S.train_mask, JS.train_mask)):
        o, t = ours(scales, ratio), theirs(scales, ratio)
        if ratio == 0:
            assert o is None and t is None
        else:
            assert o.dtype == t.dtype
            np.testing.assert_array_equal(o, t)


def _specs(n=len(LENGTHS), seed=3):
    rng = np.random.default_rng(seed)
    specs = rng.standard_normal((n, int(LENGTHS.max()), D)).astype(np.float32)
    for i, n_frames in enumerate(LENGTHS[:n]):
        specs[i, n_frames:] = 0.0
    return specs


@functools.lru_cache(maxsize=None)
def _models(pred):
    jm, params, stats = jax_backbone(H, pred, None, WIN, D, seed=0 if pred == "emotion" else 1)
    port = Conv2dBiRNN(H, D, pred)
    port.load_state_dict(backbone_state_dict(params, stats))
    return jm, params, stats, port


def test_sliding_vote_matches_jax():
    jm, params, stats, port = _models("emotion")
    specs = np.concatenate([_specs(), np.zeros((2, int(LENGTHS.max()), D), np.float32)])
    lengths = np.concatenate([LENGTHS, np.full(2, WIN, np.int32)])  # two pad rows
    want, want_n = jax_vote_fn(jax_eval_logits_fn(jm), WIN, SHIFT)(params, stats, specs, lengths)
    got, got_n = make_sliding_vote_fn(make_eval_logits_fn(port), WIN, SHIFT)(
        torch.from_numpy(specs), torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    preds, probs = sliding_vote(make_eval_logits_fn(port), specs, lengths, WIN, SHIFT,
                                device="cpu")
    np.testing.assert_array_equal(probs, got.numpy())
    np.testing.assert_array_equal(preds, got.numpy().argmax(-1))
    assert port.training  # the eval forward put the mode back


def test_sliding_entry_points_need_cuda(monkeypatch):
    """vote_split and sliding_vote run on the card unless asked for the CPU:
    without one they raise instead of voting on the CPU."""
    _, _, _, port = _models("emotion")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    specs, lengths = _specs(), LENGTHS
    with pytest.raises(RuntimeError, match="cuda"):
        sliding_vote(make_eval_logits_fn(port), specs, lengths, WIN, SHIFT)
    vote = make_sliding_vote_fn(make_eval_logits_fn(port), WIN, SHIFT)
    with pytest.raises(RuntimeError, match="cuda"):
        vote_split(vote, _test_split(SplitArrays), WIN, 4)
    probs = vote_split(vote, _test_split(SplitArrays), WIN, 4, device="cpu")
    np.testing.assert_allclose(probs, sliding_vote(make_eval_logits_fn(port), specs, lengths,
                                                   WIN, SHIFT, device="cpu")[1], atol=1e-6)


def _test_split(split_cls, n=len(LENGTHS)):
    rng = np.random.default_rng(11)
    return split_cls(windows=_specs(n), labels_emo=rng.integers(0, 4, n).astype(np.int32),
                     labels_gen=rng.integers(0, 2, n).astype(np.int32), lengths=LENGTHS[:n],
                     global_data=np.zeros((n, 88), np.float32),
                     speaker_ids=np.array(["s"] * n, object), datasets=DATASETS[:n],
                     utt_ids=np.array([f"u{i}" for i in range(n)], object))


def test_run_test_matches_jax():
    """Batches of 4 over 10 utterances: the last batch carries two pad rows."""
    jm, params, stats, port = _models("emotion")
    kw = dict(win_len=WIN, hidden_size=H, feature_len=D)
    state = type("S", (), {"params": params, "batch_stats": stats})
    want = jax_run_test(jax_eval_logits_fn(jm), state, _test_split(JaxSplit), JaxConfig(**kw),
                        batch_size=4)
    got = run_test(make_eval_logits_fn(port), _test_split(SplitArrays), ExperimentConfig(**kw),
                   batch_size=4, device="cpu")
    np.testing.assert_array_equal(got["preds"], want["preds"])
    np.testing.assert_array_equal(got["conf"], want["conf"])
    assert (got["acc"], got["uar"], got["per_dataset"]) == (
        want["acc"], want["uar"], want["per_dataset"])


@functools.lru_cache(maxsize=None)
def _jax_sweep():
    """JAX's joint forward as cli/evaluate.py builds it, its noise params and
    the epsilon it draws from PRNGKey(8)."""
    je, pe, se, _ = _models("emotion")
    ja, pa, sa, _ = _models("gender")
    noise = JaxCloakNoise(win_len=WIN, n_feats=D, max_scale=5.0)
    rng = np.random.default_rng(5)
    noise_params = {"params": {
        "locs": (0.1 * rng.standard_normal((WIN, D))).astype(np.float32),
        "rhos": (rng.uniform(-2.5, 0.5, (WIN, D))).astype(np.float32)}}
    emo_fn, adv_fn = jax_eval_logits_fn(je), jax_eval_logits_fn(ja)

    def joint_logits(fn_params, wins, g, m, key):
        noise_vars, base_p, adv_p = fn_params
        noised = noise.apply(noise_vars, wins[..., 0], m, rngs={"noise": key})[..., None]
        return jnp.concatenate([emo_fn(base_p["params"], base_p["batch_stats"], noised, g),
                                adv_fn(adv_p["params"], adv_p["batch_stats"], noised, g)], -1)

    fn_params = (noise_params, {"params": pe, "batch_stats": se},
                 {"params": pa, "batch_stats": sa})
    key = jax.random.PRNGKey(8)
    out = noise.apply(noise_params, jnp.zeros((WIN, D)), jnp.ones((WIN, D)),
                      rngs={"noise": key})
    scales = np.asarray(noise.apply(noise_params, method=JaxCloakNoise.scales))
    eps = (np.asarray(out) - noise_params["params"]["locs"]) / scales
    return joint_logits, fn_params, key, scales, torch.from_numpy(eps)[None]


def _sweep_model():
    _, fn_params, _, _, _ = _jax_sweep()
    model = S.SweepModel(Conv2dBiRNN(H, D, "emotion"), Conv2dBiRNN(H, D, "gender"), WIN, D)
    noise = fn_params[0]["params"]
    cloak = {f"noise.{k}": torch.from_numpy(v[None]) for k, v in noise.items()}
    return model.load_cell(cloak, _models("emotion")[3].state_dict(),
                           _models("gender")[3].state_dict())


@pytest.mark.parametrize("ratio", [0, 40])
def test_evaluate_cloaked_test_matches_jax(ratio):
    joint_logits, fn_params, key, scales, eps = _jax_sweep()
    model = _sweep_model()
    # torch's and XLA's tanh part by an ulp, which 1 + tanh(rho) turns into
    # up to 6e-6 relative where rho < 0 (4.5e-7 absolute)
    np.testing.assert_allclose(model.noise.scales().detach()[0].numpy(), scales, atol=1e-6)
    mask = JS.eval_mask(scales, ratio)
    test = _test_split(JaxSplit)
    jb, ja = JS.evaluate_cloaked_test(joint_logits, fn_params, test, mask, win_len=WIN,
                                      shift_len=SHIFT, batch_size=4)
    b, a = S.evaluate_cloaked_test(model, _test_split(SplitArrays), mask, win_len=WIN,
                                   shift_len=SHIFT, batch_size=4, eps=eps)
    # JAX's probabilities, as its evaluate_cloaked_test votes them
    vote = jax_vote_fn(lambda p, _s, wins, g: joint_logits(p[0], wins, g, p[1], p[2]), WIN, SHIFT,
                       head_sizes=(4, 2))
    mask_arr = jnp.ones((WIN, D)) if mask is None else jnp.asarray(mask)
    want = np.asarray(vote((fn_params, mask_arr, key), None, test.windows, test.lengths)[0])
    np.testing.assert_allclose(np.concatenate([b["probs"], a["probs"]], -1), want, atol=1e-5)
    for ours, theirs in ((b, jb), (a, ja)):
        assert (ours["acc"], ours["rec"], ours["per_dataset"]) == (
            theirs["acc"], theirs["rec"], theirs["per_dataset"])
        np.testing.assert_array_equal(ours["conf"], theirs["conf"])


def test_mask_none_equals_all_ones():
    _, _, _, _, eps = _jax_sweep()
    model = _sweep_model()
    test = _test_split(SplitArrays)
    kw = dict(win_len=WIN, shift_len=SHIFT, batch_size=4, eps=eps)
    b0, a0 = S.evaluate_cloaked_test(model, test, None, **kw)
    b1, a1 = S.evaluate_cloaked_test(model, test, np.ones((WIN, D), np.float32), **kw)
    np.testing.assert_array_equal(b0["probs"], b1["probs"])
    np.testing.assert_array_equal(a0["probs"], a1["probs"])


def test_sweep_rows_and_csv_match_jax(tmp_path):
    rng = np.random.default_rng(9)

    def result():
        return {"acc": float(rng.random()), "rec": float(rng.random()),
                "per_dataset": {ds: {"acc": float(rng.random()), "rec": float(rng.random())}
                                for ds in ("iemocap", "crema-d")}}

    per_fold = {r: [(result(), result()) for _ in range(3)] for r in (0, 20, 40, 60, 80)}
    ours, theirs = S.sweep_to_rows(per_fold, "combine"), JS.sweep_to_rows(per_fold, "combine")
    assert len(ours) == 15
    assert [r.index for r in ours] == [r.index for r in theirs]
    S.rows_to_csv(ours, tmp_path / "ours.csv")
    JS.rows_to_csv(theirs, tmp_path / "theirs.csv")
    assert (tmp_path / "ours.csv").read_text() == (tmp_path / "theirs.csv").read_text()
