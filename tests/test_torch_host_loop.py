"""The port's host fold loop (``train/loop.py``: ``fit``, ``run_train_epoch``,
``run_eval_epoch``) vs the JAX package's (CPU).

Both ``fit``s run from the same weights (seeded numpy draws in the shapes
of the JAX model's tree, which is traced, not initialised, to spare a
compile; carried over by sept_tpu_torch.compat.from_jax) on the same
splits, dropout 0, the same seed, so ``batch_iterator`` draws the same
numpy shuffle on both sides; the training split (20 windows, batches of 8)
ends in a padded batch.  The baseline trains in combine mode (speaker
weights on every batch, the validation loss too), the attention model with
both heads (``pred="multitask"``, ``att="self_att"``), and the GRL cloak
with JAX's epsilon draws recovered from the noise it adds to an all-zero
input and injected into the port's steps (as tests/test_torch_fold.py
does).  Tolerances are tests/test_torch_fold.py's: per-epoch train loss,
validation loss and test accuracy 1e-4; validation accuracy, best epoch
and stop epoch equal; the best state's parameters and running statistics
1e-4 * max(|p|, 1).
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.models import CloakedModelGRL as JaxCloakedGRL
from sept_tpu.models import Conv2dBiRNN as JaxConv2dBiRNN
from sept_tpu.train import ExperimentConfig as JaxConfig
from sept_tpu.train import make_baseline_step as jax_baseline_step
from sept_tpu.train import make_cloak_grl_step as jax_grl_step
from sept_tpu.train import make_cloak_optimizer as jax_cloak_optimizer
from sept_tpu.train import make_eval_logits_fn as jax_eval_logits_fn
from sept_tpu.train import make_optimizer as jax_make_optimizer
from sept_tpu.train.loop import fit as jax_fit
from sept_tpu.train.loop import run_eval_epoch as jax_run_eval_epoch
from sept_tpu.train.loop import speaker_weights as jax_speaker_weights
from sept_tpu_torch.compat.from_jax import backbone_state_dict, cloaked_grl_state_dict
from sept_tpu_torch.models import CloakedModelGRL, Conv2dBiRNN
from sept_tpu_torch.train import (ExperimentConfig, fit, init_state, make_baseline_step,
                                  make_cloak_grl_step, make_cloak_optimizer,
                                  make_eval_logits_fn, make_optimizer, run_eval_epoch,
                                  speaker_weights)
from sept_tpu_torch.train.device_loop import _run_epoch_loop
from sept_tpu_torch.train.steps import TrainState

from test_torch_fold import (B, D, H, STEPS, WIN, _assert_close, _assert_history, _cfg_kw,
                             _jax_eps, _jax_state, _splits)


@functools.lru_cache(maxsize=None)
def _weights(pred, att=None, seed=0):
    """(params, batch_stats) of a JAX Conv2dBiRNN as seeded numpy trees in
    the shapes ``init`` gives: kernels N(0, 1 / fan_in), biases N(0, 0.05),
    BN scales 1 + N(0, 0.05), running means N(0, 0.1) and variances 1 +
    U(0, 0.5)."""
    model = JaxConv2dBiRNN(hidden_size=H, pred=pred, att=att)
    shapes = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0)},
                            jnp.zeros((1, WIN, D, 1)))
    rng = np.random.default_rng(seed + 100)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "scale":
            a = 1.0 + 0.05 * rng.standard_normal(shape)
        elif name == "mean":
            a = 0.1 * rng.standard_normal(shape)
        elif name == "var":
            a = 1.0 + 0.5 * rng.random(shape)
        else:
            a = 0.05 * rng.standard_normal(shape)
        return a.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return tree["params"], tree["batch_stats"]


@functools.lru_cache(maxsize=None)
def _jax_logits(pred, att):
    """JAX's eval forward of one backbone, one jitted function a model, so
    that its compiles are shared."""
    return jax_eval_logits_fn(JaxConv2dBiRNN(hidden_size=H, pred=pred, att=att,
                                             dropout_rate=0.0))


def _port_backbone(params, stats, pred, att=None):
    model = Conv2dBiRNN(H, D, pred, att=att, dropout_rate=0.0)
    model.load_state_dict(backbone_state_dict(params, stats))
    return model


@functools.lru_cache(maxsize=None)
def _baseline_pair(pred, att):
    """(port result, port state, JAX result) of both ``fit``s of one
    backbone with combine-mode speaker weights; the port's history also
    carries an ``epoch_callback``'s entries."""
    (jtr, jva, jte), (tr, va, te) = _splits()
    kw = _cfg_kw(pred=pred, att=att, num_epochs=3)
    params, stats = _weights(pred, att)
    jm = JaxConv2dBiRNN(hidden_size=H, pred=pred, att=att, dropout_rate=0.0)
    tx = jax_make_optimizer(JaxConfig(**kw), STEPS)
    jres = jax_fit(_jax_state(params, stats, tx), jax_baseline_step(jm, tx),
                   _jax_logits(pred, att), jtr, jva, jte, JaxConfig(**kw),
                   spk_weights=jax_speaker_weights(jtr), verbose=False)
    model = _port_backbone(params, stats, pred, att)
    cfg = ExperimentConfig(**kw)
    state = init_state(model, make_optimizer(cfg, STEPS, model), device="cpu")
    calls = []

    def callback(st):
        calls.append(st.step)
        return {"step": st.step}

    res = fit(state, make_baseline_step(), make_eval_logits_fn(model), tr, va, te, cfg,
              spk_weights=speaker_weights(tr), verbose=False, epoch_callback=callback)
    assert calls == [STEPS * (e + 1) for e in range(len(res.history))]
    return res, state, jres


@pytest.mark.parametrize("pred, att", [("emotion", None), ("multitask", "self_att")],
                         ids=["baseline", "att_multitask"])
def test_fit_matches_jax(pred, att):
    res, state, jres = _baseline_pair(pred, att)
    _assert_history(res, jres)
    for o, t in zip(res.history, jres.history):
        assert o["train"]["acc"] == t["train"]["acc"]
        assert o["train"]["uar"] == pytest.approx(t["train"]["uar"], abs=1e-12)
        np.testing.assert_array_equal(o["train"]["conf"], t["train"]["conf"])
        assert o["validate"]["uar"] == t["validate"]["uar"]
    want = backbone_state_dict(jax.tree.map(np.asarray, jres.best_state.params),
                               jax.tree.map(np.asarray, jres.best_state.batch_stats))
    _assert_close(res.best_state["model"], want)
    assert state.step == STEPS * len(res.history)
    assert state.model.training


def test_fit_profiles_its_first_epoch(tmp_path):
    """``profile_dir`` writes one trace, of the first training epoch, with
    the steps' spans in it."""
    _, (tr, va, te) = _splits()
    cfg = ExperimentConfig(**_cfg_kw(num_epochs=2))
    params, stats = _weights("emotion")
    model = _port_backbone(params, stats, "emotion")
    state = init_state(model, make_optimizer(cfg, STEPS, model), device="cpu")
    fit(state, make_baseline_step(), make_eval_logits_fn(model), tr, va, te, cfg,
        verbose=False, profile_dir=str(tmp_path / "prof"))
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    text = traces[0].read_text()
    assert "aten::convolution" in text
    for name in ("train.step", "train.forward", "train.backward", "train.optimizer"):
        assert f'"name": "{name}"' in text, name


def test_fit_cloak_grl_matches_jax():
    (jtr, jva, jte), (tr, va, te) = _splits()
    kw = _cfg_kw(scale_lambda=0.1, grl=True, lr_sched_steps_per_epoch=1, num_epochs=3,
                 early_stop_patience=10)
    pe, se = _weights("emotion")
    pg, sg = _weights("gender", seed=1)
    rng = np.random.default_rng(7)
    noise = {"locs": (0.1 * rng.standard_normal((WIN, D))).astype(np.float32),
             "rhos": (-2 + 0.5 * rng.standard_normal((WIN, D))).astype(np.float32)}
    params = {"noise": noise, "emotion_backbone": pe, "gender_backbone": pg}
    stats = {"emotion_backbone": se, "gender_backbone": sg}
    jb = lambda pred: JaxConv2dBiRNN(hidden_size=H, pred=pred, dropout_rate=0.0)  # noqa: E731
    jm = JaxCloakedGRL(emotion_backbone=jb("emotion"), gender_backbone=jb("gender"),
                       grl_lambda=0.1, win_len=WIN, n_feats=D)
    prefixes = ("noise", "gender_backbone")
    cfg_j = JaxConfig(**kw)
    tx = jax_cloak_optimizer(cfg_j, STEPS, params, prefixes)
    jst = _jax_state(params, stats, tx, key=3)

    def eval_logits(p, bs, spec, g=None):
        return jm.apply({"params": p, "batch_stats": bs}, spec,
                        rngs={"noise": jax.random.PRNGKey(0)})[0]

    step_j = jax_grl_step(jm, tx, scale_lambda=cfg_j.scale_lambda,
                          gender_lambda=cfg_j.gender_lambda)
    jres = jax_fit(jst, step_j, jax.jit(eval_logits), jtr, jva, jte, cfg_j, verbose=False)

    # every step's draw, in the order the host loop takes the steps
    draws, key = [], jst.rng
    for _ in range(kw["num_epochs"] * STEPS):
        key, n_rng, d_rng = jax.random.split(key, 3)
        draws.append(_jax_eps(jm, params, stats, {"noise": n_rng, "dropout": d_rng}, True))
    eval_eps = _jax_eps(jm, params, stats, {"noise": jax.random.PRNGKey(0)}, False)

    tb = lambda pred: Conv2dBiRNN(H, D, pred, dropout_rate=0.0)  # noqa: E731
    model = CloakedModelGRL(tb("emotion"), tb("gender"), grl_lambda=0.1, win_len=WIN, n_feats=D)
    model.load_state_dict(cloaked_grl_state_dict(params, stats))
    cfg = ExperimentConfig(**kw)
    state = init_state(model, make_cloak_optimizer(cfg, STEPS, model, prefixes), device="cpu")
    grl_step = make_cloak_grl_step(scale_lambda=cfg.scale_lambda,
                                   gender_lambda=cfg.gender_lambda)
    injected = iter(draws)

    def step(st, batch, mask=None):
        return grl_step(st, batch, mask=mask, eps=next(injected))

    res = fit(state, step, make_eval_logits_fn(model, eps=eval_eps, mask=None), tr, va, te,
              cfg, verbose=False)
    assert next(injected, None) is None  # every draw taken, one a step
    _assert_history(res, jres)
    want = cloaked_grl_state_dict(jax.tree.map(np.asarray, jres.best_state.params),
                                  jax.tree.map(np.asarray, jres.best_state.batch_stats))
    _assert_close(res.best_state["model"], want)


def test_run_eval_epoch_with_speaker_weights_matches_jax():
    """The validation pass alone: speaker weights scale the numerator of
    each batch's CE, a padded last batch, the loss the mean over batches."""
    (_, jva, _), (_, va, _) = _splits()
    cfg_kw = _cfg_kw()
    params, stats = _weights("emotion")
    spk = {"s0_iemocap": 2.5, "s1_crema-d": 0.5, "s2_iemocap": 1.5}
    state = SimpleNamespace(params=params, batch_stats=stats)
    theirs = jax_run_eval_epoch(_jax_logits("emotion", None), state, jva, JaxConfig(**cfg_kw),
                                spk_weights=spk)
    logits_fn = make_eval_logits_fn(_port_backbone(params, stats, "emotion"))
    ours = run_eval_epoch(logits_fn, va, ExperimentConfig(**cfg_kw), spk_weights=spk,
                          device="cpu")
    plain = run_eval_epoch(logits_fn, va, ExperimentConfig(**cfg_kw), device="cpu")
    assert ours.keys() == theirs.keys() == {"loss", "acc", "uar"}
    assert ours["loss"] == pytest.approx(theirs["loss"], abs=1e-5)
    assert (ours["acc"], ours["uar"]) == (theirs["acc"], theirs["uar"])
    assert abs(ours["loss"] - plain["loss"]) > 1e-3  # the weights reached the loss


def test_fit_needs_cuda_by_default(monkeypatch):
    """A state whose generator lies on ``cuda`` without a card raises before
    any batch moves."""
    _, (tr, va, te) = _splits()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = TrainState(model=None, optimizer=None,
                       generator=SimpleNamespace(device=torch.device("cuda")))
    with pytest.raises(RuntimeError, match="cuda"):
        fit(state, None, None, tr, va, te, ExperimentConfig(batch_size=B), verbose=False)


def test_epoch_loop_refuses_resume_without_its_shuffle(tmp_path):
    """A caller that shuffles itself (``needs_order=False``) cannot resume:
    replay restores the loop's own stream only."""
    with pytest.raises(ValueError, match="needs_order"):
        _run_epoch_loop(None, ExperimentConfig(), train_epoch=None, val_epoch=None,
                        test_epoch=None, m_total=8, needs_order=False,
                        resume_path=str(tmp_path / "mid"))
    assert not (tmp_path / "mid").exists()
