"""The 88-dim global feature (``--global_feature 1``) in the PyTorch port vs
the JAX package (CPU).

Models are built with ``global_dim=N_GLOBAL`` (JAX: initialized with a
global vector), their weights perturbed JAX parameters carried over by
sept_tpu_torch.compat.from_jax (which carries ``dense1`` / ``classifier``
at the pooled width plus 88), dropout 0; every batch holds a seeded (B, 88)
global vector.  Tolerances:

- eval logits of every model type that takes the vector, 1e-4 (as
  tests/test_torch_model_zoo.py); ``PlainConv2d`` takes and ignores it, as
  JAX's does;
- three f32 steps each of the baseline, multitask, cloak and GRL cloak
  (with and without the saliency term) workloads and one epoch of each
  epoch runner against the jitted JAX steps, epsilon injected as in
  tests/test_torch_cloak_train.py: losses, parameters and running
  statistics within 1e-4 * max(|p|, 1);
- one bf16 baseline forward and backward with the vector against JAX's
  eager bf16 ``fused1`` model at tests/test_torch_model_zoo_bf16.py's
  bounds (logits 0.02 of max(|logits|, 0.1), running statistics 5e-4 *
  max(|s|, 1), gradients max(0.05 * max |g|, 0.02));
- ``run_test`` (the port's ``vote_split``) and ``evaluate_cloaked_test``
  with the vector against JAX's: predictions and metrics exact, voted
  probabilities 1e-5.
"""

import functools
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.data.pipeline import SplitArrays as JaxSplit
from sept_tpu.eval import sweep as JS
from sept_tpu.eval.sliding import make_sliding_vote_fn as jax_vote_fn
from sept_tpu.models import CloakedModel as JaxCloaked
from sept_tpu.models import CloakedModelGRL as JaxCloakedGRL
from sept_tpu.models import CloakNoise as JaxCloakNoise
from sept_tpu.models import build_backbone as jax_build_backbone
from sept_tpu.models import compute_dtype as jax_compute_dtype
from sept_tpu.models import pooling_for
from sept_tpu.train import ExperimentConfig as JaxConfig
from sept_tpu.train import make_cloak_optimizer as jax_cloak_optimizer
from sept_tpu.train import make_eval_logits_fn as jax_eval_logits_fn
from sept_tpu.train import make_optimizer as jax_make_optimizer
from sept_tpu.train import steps as JST
from sept_tpu.train.loop import run_test as jax_run_test
from sept_tpu_torch.compat.from_jax import (
    backbone_state_dict,
    cloaked_grl_state_dict,
    cloaked_state_dict,
)
from sept_tpu_torch.data.pipeline import SplitArrays
from sept_tpu_torch.eval import sweep as S
from sept_tpu_torch.models import (
    N_GLOBAL,
    CloakedModel,
    CloakedModelGRL,
    build_backbone,
    compute_dtype,
)
from sept_tpu_torch.train import steps as ST
from sept_tpu_torch.train.config import ExperimentConfig
from sept_tpu_torch.train.loop import run_test
from sept_tpu_torch.train.optim import make_cloak_optimizer, make_optimizer

from _torch_helpers import _perturb

H, WIN, D, B, STEPS = 8, 40, 16, 8, 3
SCALE_LAMBDA, GENDER_LAMBDA, SALIENCY = 0.1, 0.1, 0.5
CFG = dict(optimizer="sgd", learning_rate=1e-2, weight_decay=1e-4)
TOL = 1e-4


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


@functools.lru_cache(maxsize=None)
def _jax_global(model_type="2d-cnn-lstm", pred="emotion", att=None, win=WIN, d=D, hidden=H,
                seed=0):
    """(model, params, stats) of a JAX backbone initialized with a global
    vector (``dense1`` pooled + 88 wide), perturbed as _torch_helpers does."""
    jm = jax_build_backbone(model_type, hidden_size=hidden, pred=pred, att=att, dropout_rate=0.0)
    init = functools.partial(jm.init, pooling=pooling_for(model_type))
    v = jax.jit(init)({"params": jax.random.PRNGKey(seed)}, jnp.zeros((1, win, d, 1)),
                      global_feature=jnp.zeros((1, N_GLOBAL)))
    rng = np.random.default_rng(seed + 100)
    params = _perturb(jax.tree_util.tree_map(np.asarray, v["params"]), rng, 0.05)
    stats = {name: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(np.float32),
                    "var": (1.0 + 0.5 * rng.random(s["var"].shape)).astype(np.float32)}
             for name, s in v.get("batch_stats", {}).items()}
    return jm, params, stats


def _port(model_type="2d-cnn-lstm", pred="emotion", att=None, win=WIN, seed=0, **kw):
    _, params, stats = _jax_global(model_type, pred, att, win, seed=seed)
    m = build_backbone(model_type, hidden_size=H, feature_len=D, win_len=win, pred=pred,
                       att=att, dropout_rate=0.0, global_dim=N_GLOBAL, **kw)
    m.load_state_dict(backbone_state_dict(params, stats), strict=True)
    return m


def _heads(out):
    return list(out) if isinstance(out, tuple) else [out]


CASES = [("2d-cnn-lstm", "emotion", None, WIN), ("cnn-lstm-att", "multitask", "self_att", WIN),
         ("deep-2d-cnn-lstm", "emotion", None, WIN), ("1d-cnn-lstm-att", "gender", None, 50),
         ("1d-cnn-lstm-att", "emotion", "self_att", 50), ("2d-cnn", "emotion", None, WIN)]


@pytest.mark.parametrize("model_type,pred,att,win", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_logits_with_global_match_jax(model_type, pred, att, win):
    jm, params, stats = _jax_global(model_type, pred, att, win)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, win, D, 1)).astype(np.float32)
    g = rng.standard_normal((B, N_GLOBAL)).astype(np.float32)
    pooling = pooling_for(model_type)
    apply = jax.jit(lambda v, x, g: jm.apply(v, x, global_feature=g, pooling=pooling))
    variables = {"params": params, "batch_stats": stats}
    want = apply(variables, jnp.asarray(x), jnp.asarray(g))
    port = _port(model_type, pred, att, win).eval()
    with torch.inference_mode():
        got = port(_nchw(x), pooling=pooling, global_feature=torch.from_numpy(g))
        moved = port(_nchw(x), pooling=pooling, global_feature=torch.zeros(B, N_GLOBAL))
    for o, w in zip(_heads(got), _heads(want)):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), atol=1e-4)
    same = model_type == "2d-cnn"  # takes the vector and ignores it
    assert torch.equal(_heads(got)[0], _heads(moved)[0]) == same
    if not same:
        dense = port.classifier if model_type.startswith("1d") else port.dense1
        pooled = {"deep-2d-cnn-lstm": 2 * H * (win // 8), "1d-cnn-lstm-att": 512 * (
            win // 50) if att is None else 512}.get(model_type, 2 * H)
        assert dense.in_features == pooled + N_GLOBAL


def _noise_params(seed=7):
    rng = np.random.default_rng(seed)
    return {"locs": (0.1 * rng.standard_normal((WIN, D))).astype(np.float32),
            "rhos": (-2 + 0.5 * rng.standard_normal((WIN, D))).astype(np.float32)}


class _NoiseOnly(fnn.Module):
    """The cloaked models' noise layer at their scope path ("noise"), so that
    it draws their epsilon from the same key."""

    @fnn.compact
    def __call__(self, x):
        return JaxCloakNoise(win_len=WIN, n_feats=D, name="noise")(x)


@functools.lru_cache(maxsize=None)
def _noise_fn():
    return jax.jit(lambda p, key: _NoiseOnly().apply({"params": {"noise": p}},
                                                     jnp.zeros((1, WIN, D)),
                                                     rngs={"noise": key}))


def _jax_eps(params, key):
    """The epsilon the JAX cloaked models draw from ``key``, (1, WIN, D)."""
    noise = np.asarray(_noise_fn()(params["noise"], key))[0]
    scales = np.asarray(JST.cloak_scales(JaxCloakNoise(), params))
    return torch.from_numpy((noise - np.asarray(params["noise"]["locs"])) / scales)[None]


def _batches(seed=1):
    rng = np.random.default_rng(seed)
    return [dict(spec=rng.standard_normal((B, WIN, D, 1)).astype(np.float32),
                 labels_emo=rng.integers(0, 4, B).astype(np.int32),
                 labels_gen=rng.integers(0, 2, B).astype(np.int32),
                 weight=np.r_[np.ones(B - 1), np.zeros(1)].astype(np.float32),
                 **{"global": rng.standard_normal((B, N_GLOBAL)).astype(np.float32)})
            for _ in range(STEPS)]


def _torch_batch(b):
    return {"spec": _nchw(b["spec"]), "labels_emo": torch.from_numpy(b["labels_emo"]).long(),
            "labels_gen": torch.from_numpy(b["labels_gen"]).long(),
            "weight": torch.from_numpy(b["weight"]), "global": torch.from_numpy(b["global"])}


def _setup(workload):
    """(JAX state, its step or runner args, port state, port step, state
    dict mapping, frozen prefixes, eps key split) of a workload."""
    pred = "multitask" if workload == "multitask" else "emotion"
    jb = functools.partial(jax_build_backbone, "2d-cnn-lstm", hidden_size=H, dropout_rate=0.0)
    if workload in ("baseline", "multitask"):
        _, params, stats = _jax_global(pred=pred)
        tx = jax_make_optimizer(JaxConfig(**CFG), 10)
        port = _port(pred=pred)
        opt = make_optimizer(ExperimentConfig(**CFG), 10, port)
        jm, to_sd, frozen, split = jb(pred=pred), backbone_state_dict, (), 0
    elif workload == "cloak":
        _, pe, se = _jax_global()
        params, stats = {"noise": _noise_params(), "backbone": pe}, {"backbone": se}
        jm = JaxCloaked(backbone=jb(pred="emotion"), win_len=WIN, n_feats=D)
        port = CloakedModel(_port(), win_len=WIN, n_feats=D)
        port.load_state_dict(cloaked_state_dict(params, stats))
        tx = jax_cloak_optimizer(JaxConfig(**CFG), 10, params, ("noise",))
        opt = make_cloak_optimizer(ExperimentConfig(**CFG), 10, port, ("noise",))
        to_sd, frozen, split = cloaked_state_dict, ("backbone.",), 2
    else:
        _, pe, se = _jax_global()
        _, pg, sg = _jax_global(pred="gender", seed=1)
        params = {"noise": _noise_params(), "emotion_backbone": pe, "gender_backbone": pg}
        stats = {"emotion_backbone": se, "gender_backbone": sg}
        jm = JaxCloakedGRL(emotion_backbone=jb(pred="emotion"), gender_backbone=jb(pred="gender"),
                           grl_lambda=0.1, win_len=WIN, n_feats=D)
        port = CloakedModelGRL(_port(), _port(pred="gender", seed=1), grl_lambda=0.1,
                               win_len=WIN, n_feats=D)
        port.load_state_dict(cloaked_grl_state_dict(params, stats))
        prefixes = ("noise", "gender_backbone")
        tx = jax_cloak_optimizer(JaxConfig(**CFG), 10, params, prefixes)
        opt = make_cloak_optimizer(ExperimentConfig(**CFG), 10, port, prefixes)
        to_sd, frozen, split = cloaked_grl_state_dict, ("emotion_backbone.",), 3
    jst = JST.TrainState(params=params, batch_stats=stats, opt_state=tx.init(params),
                         rng=jax.random.PRNGKey(3), step=jnp.zeros((), jnp.int32))
    return jm, tx, jst, ST.init_state(port, opt, device="cpu"), to_sd, frozen, split


def _assert_state(port, before, jst, to_sd, frozen):
    want = to_sd(jax.tree.map(np.asarray, jst.params), jax.tree.map(np.asarray, jst.batch_stats))
    got = port.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith(frozen):
            assert torch.equal(got[k], before[k]), f"frozen {k} moved"
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, atol=TOL * max(np.abs(w).max(), 1.0),
                                   err_msg=k)
    assert any(not torch.equal(got[k], before[k]) for k in got)


@pytest.mark.parametrize("workload", ["baseline", "multitask", "cloak", "grl", "grl_saliency"])
def test_steps_with_global_match_jax(workload):
    jm, tx, jst, state, to_sd, frozen, split = _setup(workload)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    if workload in ("baseline", "multitask"):
        jstep = JST.make_baseline_step(jm, tx, use_global=True)
        step = ST.make_baseline_step(use_global=True)
    elif workload == "cloak":
        jstep = JST.make_cloak_step(jm, tx, scale_lambda=SCALE_LAMBDA, use_global=True)
        step = ST.make_cloak_step(scale_lambda=SCALE_LAMBDA, use_global=True)
    else:
        sal = SALIENCY if workload == "grl_saliency" else 0.0
        jstep = JST.make_cloak_grl_step(jm, tx, scale_lambda=SCALE_LAMBDA,
                                        gender_lambda=GENDER_LAMBDA, use_global=True,
                                        saliency_align=sal)
        step = ST.make_cloak_grl_step(scale_lambda=SCALE_LAMBDA, gender_lambda=GENDER_LAMBDA,
                                      saliency_align=sal, use_global=True)
    for b in _batches():
        kw = {"eps": _jax_eps(jst.params, jax.random.split(jst.rng, split)[1])} if split else {}
        jst, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, _torch_batch(b), **kw)
        want = float(jmet["loss"])
        assert float(m["loss"]) == pytest.approx(want, abs=TOL * max(abs(want), 1.0))
        assert float(m["correct"]) == float(jmet["correct"])
    _assert_state(state.model, before, jst, to_sd, frozen)


@pytest.mark.parametrize("workload", ["baseline", "grl"])
def test_epoch_runners_with_global_match_jax(workload):
    jm, tx, jst, state, to_sd, frozen, _ = _setup(workload)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    rng = np.random.default_rng(5)
    rows = STEPS * B
    windows = rng.standard_normal((rows, WIN, D)).astype(np.float32)
    globals_ = rng.standard_normal((rows, N_GLOBAL)).astype(np.float32)
    le, lg = (np.arange(rows) % 4).astype(np.int32), (np.arange(rows) % 2).astype(np.int32)
    w = np.ones(rows, np.float32)
    w[:2] = 0.0
    order = rng.permutation(rows)
    t, j = torch.from_numpy, jnp.asarray
    kw = dict(n_batches=STEPS, batch_size=B)
    if workload == "baseline":
        jst, jl, jc, jn = JST.make_epoch_runner(jm, tx, use_global=True)(
            jst, j(windows), j(le), j(w), j(order), globals_=j(globals_), **kw)
        state, losses, correct, counts = ST.make_epoch_runner(use_global=True)(
            state, t(windows), t(le).long(), t(w), order, globals_=t(globals_), **kw)
    else:
        eps, key = [], jst.rng
        for _ in range(STEPS):
            key, n_rng, _ = jax.random.split(key, 3)
            eps.append(_jax_eps(jst.params, n_rng))
        opts = dict(scale_lambda=SCALE_LAMBDA, gender_lambda=GENDER_LAMBDA, grl=True,
                    use_global=True)
        jst, jl, jc, jn = JST.make_cloak_epoch_runner(jm, tx, **opts)(
            jst, j(windows), j(le), j(lg), j(w), j(order), None, globals_=j(globals_), **kw)
        state, losses, correct, counts = ST.make_cloak_epoch_runner(**opts)(
            state, t(windows), t(le).long(), t(lg).long(), t(w), order, None,
            eps=torch.stack(eps), globals_=t(globals_), **kw)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=0,
                               atol=TOL * max(np.abs(np.asarray(jl)).max(), 1.0))
    np.testing.assert_array_equal(correct.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jn))
    _assert_state(state.model, before, jst, to_sd, frozen)


def test_bf16_baseline_with_global_matches_jax():
    """One train-mode forward and backward of the bf16 model (JAX's block 1
    in its interpret-mode bf16 Pallas kernels, 200 x 128 windows)."""
    win, d, hidden = 200, 128, 16
    _, params, stats = _jax_global(win=win, d=d, hidden=hidden)
    jm = jax_build_backbone("2d-cnn-lstm", hidden_size=hidden, dropout_rate=0.0,
                            dtype=jax_compute_dtype("bfloat16"), conv_backend="fused1")
    port = build_backbone("2d-cnn-lstm", hidden_size=hidden, feature_len=d, dropout_rate=0.0,
                          compute_dtype=compute_dtype("bfloat16"), global_dim=N_GLOBAL)
    port.load_state_dict(backbone_state_dict(params, stats), strict=True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, win, d, 1)).astype(np.float32)
    g = rng.standard_normal((2, N_GLOBAL)).astype(np.float32)
    labels = np.arange(2) % 4

    def loss(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                            global_feature=jnp.asarray(g), train=True, mutable=["batch_stats"])
        return -jnp.mean(jax.nn.log_softmax(out)[jnp.arange(2), labels]), (out, mut)

    (_, (want, mut)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    got = port.train()(_nchw(x), global_feature=torch.from_numpy(g))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=0.02 * max(float(jnp.abs(want).max()), 0.1))
    new_stats = jax.tree.map(np.asarray, mut["batch_stats"])
    sd = backbone_state_dict(params, new_stats)
    for k, v in port.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(),
                                       atol=5e-4 * max(float(sd[k].abs().max()), 1.0), err_msg=k)
    (-torch.log_softmax(got, -1)[torch.arange(2), torch.from_numpy(labels)].mean()).backward()
    want_g = backbone_state_dict(jax.tree.map(np.asarray, grads), new_stats)
    for k, p in port.named_parameters():
        w = want_g[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=max(0.05 * np.abs(w).max(), 0.02),
                                   err_msg=k)


LENGTHS = np.array([20, 39, 40, 41, 55, 90, 33, 70], np.int32)
SHIFT = WIN // 4  # the configs' shift_len


def _test_split(split_cls):
    rng = np.random.default_rng(11)
    n = len(LENGTHS)
    specs = rng.standard_normal((n, int(LENGTHS.max()), D)).astype(np.float32)
    for i, n_frames in enumerate(LENGTHS):
        specs[i, n_frames:] = 0.0
    return split_cls(windows=specs, labels_emo=rng.integers(0, 4, n).astype(np.int32),
                     labels_gen=rng.integers(0, 2, n).astype(np.int32), lengths=LENGTHS,
                     global_data=rng.standard_normal((n, N_GLOBAL)).astype(np.float32),
                     speaker_ids=np.array(["s"] * n, object),
                     datasets=np.array(["iemocap", "crema-d"] * (n // 2), object),
                     utt_ids=np.array([f"u{i}" for i in range(n)], object))


def test_run_test_with_global_matches_jax():
    """Batches of 3 over 8 utterances (the last one padded), each window
    with its utterance's vector."""
    jm, params, stats = _jax_global()
    kw = dict(win_len=WIN, hidden_size=H, feature_len=D, global_feature=True)
    state = type("S", (), {"params": params, "batch_stats": stats})
    want = jax_run_test(jax_eval_logits_fn(jm, use_global=True), state, _test_split(JaxSplit),
                        JaxConfig(**kw), batch_size=3)
    got = run_test(ST.make_eval_logits_fn(_port(), use_global=True), _test_split(SplitArrays),
                   ExperimentConfig(**kw), batch_size=3, device="cpu")
    np.testing.assert_array_equal(got["preds"], want["preds"])
    assert (got["acc"], got["uar"], got["per_dataset"]) == (
        want["acc"], want["uar"], want["per_dataset"])


def test_evaluate_cloaked_test_with_global_matches_jax():
    """The sweep's joint forward, as JAX's evaluate CLI builds it, with each
    utterance's vector fed to both frozen models."""
    je, pe, se = _jax_global()
    ja, pa, sa = _jax_global(pred="gender", seed=1)
    noise = JaxCloakNoise(win_len=WIN, n_feats=D, max_scale=5.0)
    rng = np.random.default_rng(5)
    noise_params = {"params": {"locs": (0.1 * rng.standard_normal((WIN, D))).astype(np.float32),
                               "rhos": rng.uniform(-2.5, 0.5, (WIN, D)).astype(np.float32)}}
    emo_fn = jax_eval_logits_fn(je, use_global=True)
    adv_fn = jax_eval_logits_fn(ja, use_global=True)

    def joint_logits(fn_params, wins, g, m, key):
        noise_vars, base_p, adv_p = fn_params
        noised = noise.apply(noise_vars, wins[..., 0], m, rngs={"noise": key})[..., None]
        return jnp.concatenate([emo_fn(base_p["params"], base_p["batch_stats"], noised, g),
                                adv_fn(adv_p["params"], adv_p["batch_stats"], noised, g)], -1)

    fn_params = (noise_params, {"params": pe, "batch_stats": se},
                 {"params": pa, "batch_stats": sa})
    key = jax.random.PRNGKey(8)
    scales = np.asarray(noise.apply(noise_params, method=JaxCloakNoise.scales))
    out = noise.apply(noise_params, jnp.zeros((WIN, D)), jnp.ones((WIN, D)), rngs={"noise": key})
    eps = torch.from_numpy((np.asarray(out) - noise_params["params"]["locs"]) / scales)[None]
    mask = JS.eval_mask(scales, 40)
    jb, ja_res = JS.evaluate_cloaked_test(joint_logits, fn_params, _test_split(JaxSplit), mask,
                                          win_len=WIN, shift_len=SHIFT, batch_size=3,
                                          use_global=True)
    model = S.SweepModel(_port(), _port(pred="gender", seed=1), WIN, D)
    model.load_cell({f"noise.{k}": torch.from_numpy(v[None])
                     for k, v in noise_params["params"].items()},
                    _port().state_dict(), _port(pred="gender", seed=1).state_dict())
    b, a = S.evaluate_cloaked_test(model, _test_split(SplitArrays), mask, win_len=WIN,
                                   shift_len=SHIFT, batch_size=3, eps=eps, use_global=True)
    test = _test_split(JaxSplit)
    vote = jax_vote_fn(lambda p, _s, wins, g: joint_logits(p[0], wins, g, p[1], p[2]), WIN,
                       SHIFT, head_sizes=(4, 2))
    want = np.asarray(vote((fn_params, jnp.asarray(mask), key), None, test.windows,
                           test.lengths, test.global_data)[0])
    np.testing.assert_allclose(np.concatenate([b["probs"], a["probs"]], -1), want, atol=1e-5)
    for ours, theirs in ((b, jb), (a, ja_res)):
        assert (ours["acc"], ours["rec"], ours["per_dataset"]) == (
            theirs["acc"], theirs["rec"], theirs["per_dataset"])


def test_multitask_step_trains_both_heads_with_global():
    """The counterpart of tests/test_multitask_global.py: ``dense1`` takes 2H
    + 88, the vector moves the logits, and a multitask step with it moves
    both heads."""
    port = _port(pred="multitask")
    assert port.dense1.in_features == 2 * H + N_GLOBAL
    b = _torch_batch(_batches()[0])
    logits = ST.make_eval_logits_fn(port, use_global=True)
    assert not torch.equal(logits(b["spec"], b["global"])[0],
                           logits(b["spec"], torch.zeros_like(b["global"]))[0])
    state = ST.init_state(port, make_optimizer(ExperimentConfig(**CFG), 10, port), device="cpu")
    heads = {k: v.clone() for k, v in port.state_dict().items() if k.startswith("pred_")}
    state, m = ST.make_baseline_step(use_global=True)(state, b)
    assert np.isfinite(float(m["loss"])) and m["preds"].shape == (B,)
    for k, v in heads.items():
        assert not torch.equal(port.state_dict()[k], v), k


def test_global_artifact_exports_and_imports(tmp_path):
    """A baseline trained with the vector round-trips through the export /
    import CLIs: ``import_torch`` reads ``global_feature`` off ``dense1``'s
    width and the weights come back bit for bit; ``load_predictor`` refuses
    it, as JAX's does."""
    from sept_tpu_torch.cli import export_torch, import_torch
    from sept_tpu_torch.serve import load_predictor
    from sept_tpu_torch.train.checkpoint import CheckpointManager

    port = _port()
    CheckpointManager(str(tmp_path / "a")).save("baseline_emotion", 1, port.state_dict(),
                                               manifest={"config": {"global_feature": True,
                                                                    "hidden_size": H,
                                                                    "feature_len": D}})
    out = str(tmp_path / "model.pt")
    export_torch.main(["--output_dir", str(tmp_path / "a"), "--artifact", "baseline_emotion",
                       "--out", out])
    import_torch.main(["--checkpoint", out, "--output_dir", str(tmp_path / "b"),
                       "--artifact", "baseline_emotion", "--win_len", str(WIN)])
    ckpt = CheckpointManager(str(tmp_path / "b"))
    back = ckpt.restore("baseline_emotion", 1, "cpu")
    for k, v in port.state_dict().items():
        assert torch.equal(back[k], v), k
    with open(tmp_path / "b" / "baseline_emotion" / "manifest_fold1.json") as f:
        assert json.load(f)["config"]["global_feature"] is True
    for root in ("a", "b"):
        with pytest.raises(ValueError, match="global_feature"):
            load_predictor(str(tmp_path / root), "baseline_emotion", 1, device="cpu")
