"""Cloak and cloak + GRL training in the PyTorch port vs the JAX package (CPU).

Three steps of ``make_cloak_step``, ``make_cloak_grl_step`` (with and
without the antithetic pair) and ``make_cloak_epoch_runner`` from the same
weights on the same batches, dropout 0.  JAX draws epsilon inside flax from
the step's noise key; the test recovers each step's draw from the noise the
JAX model adds to an all-zero input, eps = (noisy - locs) / scales, and
injects it into the port.  Tolerances: losses 1e-5 relative, trained
parameters and running statistics 1e-5 * max(|p|, 1); frozen parameters and
the frozen backbones' statistics are bit-unchanged.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.models import CloakedModel as JaxCloaked
from sept_tpu.models import CloakedModelGRL as JaxCloakedGRL
from sept_tpu.models import Conv2dBiRNN as JaxConv2dBiRNN
from sept_tpu.train import ExperimentConfig as JaxConfig
from sept_tpu.train import make_cloak_optimizer as jax_cloak_optimizer
from sept_tpu.train.steps import TrainState as JaxState
from sept_tpu.train.steps import cloak_scales as jax_cloak_scales
from sept_tpu.train.steps import make_cloak_epoch_runner as jax_cloak_runner
from sept_tpu.train.steps import make_cloak_grl_step as jax_grl_step
from sept_tpu.train.steps import make_cloak_step as jax_cloak_step
from sept_tpu_torch.compat.from_jax import cloaked_grl_state_dict, cloaked_state_dict
from sept_tpu_torch.models import CloakedModel, CloakedModelGRL, Conv2dBiRNN
from sept_tpu_torch.train.config import ExperimentConfig
from sept_tpu_torch.train.optim import make_cloak_optimizer
from sept_tpu_torch.train.steps import (
    init_state,
    make_cloak_epoch_runner,
    make_cloak_grl_step,
    make_cloak_step,
)

from _torch_helpers import jax_backbone

H, WIN, D, B = 8, 40, 16, 8
SCALE_LAMBDA, GENDER_LAMBDA = 0.1, 0.1
CFG = dict(optimizer="sgd", learning_rate=1e-2, weight_decay=1e-4)


def _noise_params(seed=7):
    rng = np.random.default_rng(seed)
    return {"locs": (0.1 * rng.standard_normal((WIN, D))).astype(np.float32),
            "rhos": (-2 + 0.5 * rng.standard_normal((WIN, D))).astype(np.float32)}


def _setup(grl):
    jb = lambda pred: JaxConv2dBiRNN(hidden_size=H, pred=pred, dropout_rate=0.0)  # noqa: E731
    tb = lambda pred: Conv2dBiRNN(hidden_size=H, feature_len=D, pred=pred,  # noqa: E731
                                  dropout_rate=0.0)
    if grl:
        _, pe, se = jax_backbone(H, "emotion", None, WIN, D)
        _, pg, sg = jax_backbone(H, "gender", None, WIN, D, seed=1)
        params = {"noise": _noise_params(), "emotion_backbone": pe, "gender_backbone": pg}
        stats = {"emotion_backbone": se, "gender_backbone": sg}
        jm = JaxCloakedGRL(emotion_backbone=jb("emotion"), gender_backbone=jb("gender"),
                           grl_lambda=0.1, win_len=WIN, n_feats=D)
        port = CloakedModelGRL(tb("emotion"), tb("gender"), grl_lambda=0.1, win_len=WIN,
                               n_feats=D)
        port.load_state_dict(cloaked_grl_state_dict(params, stats))
        prefixes = ("noise", "gender_backbone")
    else:
        _, pe, se = jax_backbone(H, "emotion", None, WIN, D)
        params, stats = {"noise": _noise_params(), "backbone": pe}, {"backbone": se}
        jm = JaxCloaked(backbone=jb("emotion"), win_len=WIN, n_feats=D)
        port = CloakedModel(tb("emotion"), win_len=WIN, n_feats=D)
        port.load_state_dict(cloaked_state_dict(params, stats))
        prefixes = ("noise",)
    tx = jax_cloak_optimizer(JaxConfig(**CFG), 10, params, prefixes)
    jstate = JaxState(params=params, batch_stats=stats, opt_state=tx.init(params),
                      rng=jax.random.PRNGKey(3), step=jnp.zeros((), jnp.int32))
    opt = make_cloak_optimizer(ExperimentConfig(**CFG), 10, port, prefixes)
    return jm, tx, jstate, init_state(port, opt, device="cpu")


@functools.lru_cache(maxsize=None)
def _noise_fn(jm):
    return jax.jit(lambda variables, rngs: jm.apply(
        variables, jnp.zeros((1, WIN, D, 1)), train=True, rngs=rngs,
        mutable=["batch_stats"])[0][-1])


def _jax_eps(jm, jstate, n_rng, d_rng=None):
    """The epsilon JAX draws from ``n_rng``, (1, WIN, D)."""
    rngs = {"noise": n_rng} if d_rng is None else {"noise": n_rng, "dropout": d_rng}
    out = _noise_fn(jm)({"params": jstate.params, "batch_stats": jstate.batch_stats}, rngs)
    noise = np.asarray(out)[0, :, :, 0]
    scales = np.asarray(jax_cloak_scales(jm, jstate.params))
    locs = np.asarray(jstate.params["noise"]["locs"])
    return torch.from_numpy((noise - locs) / scales)[None]


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [dict(spec=rng.standard_normal((B, WIN, D, 1)).astype(np.float32),
                 labels_emo=rng.integers(0, 4, B).astype(np.int32),
                 labels_gen=rng.integers(0, 2, B).astype(np.int32),
                 weight=np.r_[np.ones(B - 1), np.zeros(1)].astype(np.float32))
            for _ in range(n)]


def _torch_batch(b):
    return {"spec": torch.from_numpy(np.ascontiguousarray(np.transpose(b["spec"], (0, 3, 1, 2)))),
            "labels_emo": torch.from_numpy(b["labels_emo"]).long(),
            "labels_gen": torch.from_numpy(b["labels_gen"]).long(),
            "weight": torch.from_numpy(b["weight"])}


def _assert_trained_state(port, before, jstate, grl):
    want = (cloaked_grl_state_dict if grl else cloaked_state_dict)(
        jax.tree.map(np.asarray, jstate.params), jax.tree.map(np.asarray, jstate.batch_stats))
    got = port.state_dict()
    moved = False
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith(("backbone.", "emotion_backbone.")):
            assert torch.equal(got[k], before[k]), f"frozen {k} moved"
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-5 * max(np.abs(w).max(), 1.0),
                                   err_msg=k)
        moved |= not torch.equal(got[k], before[k])
    assert moved and not torch.equal(got["noise.locs"], before["noise.locs"])


@pytest.mark.parametrize("antithetic", [False, True], ids=["single", "antithetic"])
def test_cloak_step_matches_jax(antithetic):
    jm, tx, jst, state = _setup(grl=False)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    jstep = jax_cloak_step(jm, tx, scale_lambda=SCALE_LAMBDA, antithetic=antithetic)
    step = make_cloak_step(scale_lambda=SCALE_LAMBDA, antithetic=antithetic)
    for b in _batches(3):
        _, n_rng = jax.random.split(jst.rng)
        eps = _jax_eps(jm, jst, n_rng)
        jst, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, _torch_batch(b), eps=eps)
        assert float(m["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
        assert float(m["correct"]) == float(jmet["correct"])
    _assert_trained_state(state.model, before, jst, grl=False)


@pytest.mark.parametrize("antithetic", [False, True], ids=["single", "antithetic"])
def test_cloak_grl_step_matches_jax(antithetic):
    jm, tx, jst, state = _setup(grl=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    jstep = jax_grl_step(jm, tx, scale_lambda=SCALE_LAMBDA, gender_lambda=GENDER_LAMBDA,
                         antithetic=antithetic)
    step = make_cloak_grl_step(scale_lambda=SCALE_LAMBDA, gender_lambda=GENDER_LAMBDA,
                               antithetic=antithetic)
    for b in _batches(3):
        _, n_rng, d_rng = jax.random.split(jst.rng, 3)
        eps = _jax_eps(jm, jst, n_rng, d_rng)
        jst, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, _torch_batch(b), eps=eps)
        assert float(m["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
        assert float(m["correct"]) == float(jmet["correct"])
        assert float(m["gender_correct"]) == float(jmet["gender_correct"])
    _assert_trained_state(state.model, before, jst, grl=True)


@pytest.mark.parametrize("grl", [False, True], ids=["cloak", "grl"])
def test_cloak_epoch_runner_matches_jax(grl):
    jm, tx, jst, state = _setup(grl=grl)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    n_batches = 3
    rng = np.random.default_rng(5)
    m_rows = n_batches * B
    windows = rng.standard_normal((m_rows, WIN, D)).astype(np.float32)
    le = (np.arange(m_rows) % 4).astype(np.int32)
    lg = (np.arange(m_rows) % 2).astype(np.int32)
    w = np.ones(m_rows, np.float32)
    w[:2] = 0.0
    order = rng.permutation(m_rows)
    eps, key = [], jst.rng
    for _ in range(n_batches):
        key, n_rng, d_rng = jax.random.split(key, 3)
        eps.append(_jax_eps(jm, jst, n_rng, d_rng))
    run = jax_cloak_runner(jm, tx, scale_lambda=SCALE_LAMBDA, gender_lambda=GENDER_LAMBDA,
                           grl=grl)
    jst, jl, jc, jn = run(jst, jnp.asarray(windows), jnp.asarray(le), jnp.asarray(lg),
                          jnp.asarray(w), jnp.asarray(order), None, n_batches=n_batches,
                          batch_size=B)
    t = torch.from_numpy
    state, losses, correct, counts = make_cloak_epoch_runner(
        scale_lambda=SCALE_LAMBDA, gender_lambda=GENDER_LAMBDA, grl=grl)(
        state, t(windows), t(le).long(), t(lg).long(), t(w), order, None,
        n_batches=n_batches, batch_size=B, eps=torch.stack(eps))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_array_equal(correct.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jn))
    _assert_trained_state(state.model, before, jst, grl=grl)


def test_antithetic_minus_pass_leaves_running_stats():
    """The -eps pass of the GRL pair normalizes with its own batch moments
    but must not touch the gender backbone's running statistics: they equal
    a single-pass step's, bit for bit."""
    stats = {}
    for antithetic in (False, True):
        _, _, _, state = _setup(grl=True)
        b = _torch_batch(_batches(1, seed=9)[0])
        eps = 0.1 * torch.randn(1, WIN, D, generator=torch.Generator().manual_seed(0))
        make_cloak_grl_step(scale_lambda=SCALE_LAMBDA, antithetic=antithetic)(state, b, eps=eps)
        stats[antithetic] = {k: v for k, v in state.model.state_dict().items()
                             if "running" in k}
    assert all(torch.equal(stats[True][k], stats[False][k]) for k in stats[False])
