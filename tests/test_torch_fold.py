"""The port's fold drivers vs the JAX package's (CPU).

``fit_device`` and ``fit_device_cloak`` (the GRL game) of both packages run
from the same weights (carried over by sept_tpu_torch.compat.from_jax) on
the same splits, dropout 0, the same seed (so the same numpy shuffle
stream).  JAX draws each training step's epsilon from its state's key and
the eval epsilon from PRNGKey(0); the test recovers every draw from the
noise JAX adds to an all-zero input and injects it into the port.
Tolerances: per-epoch train loss, validation loss and test accuracy 1e-4;
validation accuracy, best epoch and stop epoch equal; the best state's
parameters and running statistics 1e-4 * max(|p|, 1).  Under Adam (m /
sqrt(v) turns f32 noise near a zero gradient into a step of lr, see
tests/test_torch_train.py) only the stop epoch and the plateau scale are
held equal.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.data.pipeline import SplitArrays as JaxSplit
from sept_tpu.models import CloakedModelGRL as JaxCloakedGRL
from sept_tpu.models import Conv2dBiRNN as JaxConv2dBiRNN
from sept_tpu.train import ExperimentConfig as JaxConfig
from sept_tpu.train import make_cloak_optimizer as jax_cloak_optimizer
from sept_tpu.train import make_eval_logits_fn as jax_eval_logits_fn
from sept_tpu.train import make_optimizer as jax_make_optimizer
from sept_tpu.train.device_loop import fit_device as jax_fit_device
from sept_tpu.train.device_loop import fit_device_cloak as jax_fit_device_cloak
from sept_tpu.train.loop import EarlyStopping as JaxEarlyStopping
from sept_tpu.train.loop import speaker_weights as jax_speaker_weights
from sept_tpu.train.steps import TrainState as JaxState
from sept_tpu.train.steps import cloak_scales as jax_cloak_scales
from sept_tpu_torch.compat.from_jax import backbone_state_dict, cloaked_grl_state_dict
from sept_tpu_torch.data.pipeline import SplitArrays
from sept_tpu_torch.models import CloakedModelGRL, Conv2dBiRNN
from sept_tpu_torch.train.config import ExperimentConfig
from sept_tpu_torch.train.device_loop import fit_device, fit_device_cloak
from sept_tpu_torch.train.loop import EarlyStopping, speaker_weights
from sept_tpu_torch.train.optim import make_cloak_optimizer, make_optimizer
from sept_tpu_torch.train.steps import init_state, make_eval_logits_fn

from _torch_helpers import jax_backbone

H, WIN, D, B = 8, 40, 16, 8
N_TRAIN, N_VAL, N_TEST, MAX_T = 20, 12, 10, 90
STEPS = -(-N_TRAIN // B)


def _arrays(n, seed, test=False):
    """Windows with a class-dependent band (so validation accuracy moves),
    two speakers of two corpora; test utterances of 25-90 frames padded to
    MAX_T."""
    rng = np.random.default_rng(seed)
    le = rng.integers(0, 4, n).astype(np.int32)
    lengths = rng.integers(25, MAX_T, n).astype(np.int32) if test else np.full(n, WIN, np.int32)
    w = rng.standard_normal((n, MAX_T if test else WIN, D)).astype(np.float32)
    w[np.arange(n), :, le * 3] += 1.5
    return dict(windows=w, labels_emo=le, labels_gen=rng.integers(0, 2, n).astype(np.int32),
                lengths=lengths, global_data=np.zeros((n, 88), np.float32),
                speaker_ids=np.array([f"s{i % 3}" for i in range(n)], object),
                datasets=np.array(["crema-d" if i % 2 else "iemocap" for i in range(n)], object),
                utt_ids=np.array([f"u{i}" for i in range(n)], object))


@functools.lru_cache(maxsize=None)
def _splits():
    arrays = [_arrays(N_TRAIN, 0), _arrays(N_VAL, 1), _arrays(N_TEST, 2, test=True)]
    return [JaxSplit(**a) for a in arrays], [SplitArrays(**a) for a in arrays]


def _cfg_kw(**over):
    kw = dict(optimizer="sgd", learning_rate=1e-2, weight_decay=1e-4, win_len=WIN,
              feature_len=D, hidden_size=H, batch_size=B, num_epochs=4, min_select_epoch=0,
              early_stop_patience=1, dataset="combine")
    kw.update(over)
    return kw


def _jax_state(params, stats, tx, key=0):
    return JaxState(params=params, batch_stats=stats, opt_state=tx.init(params),
                    rng=jax.random.PRNGKey(key), step=jnp.zeros((), jnp.int32))


def _assert_history(ours, theirs):
    assert len(ours.history) == len(theirs.history)
    for o, t in zip(ours.history, theirs.history):
        assert o["train"]["loss"] == pytest.approx(t["train"]["loss"], abs=1e-4)
        assert o["validate"]["loss"] == pytest.approx(t["validate"]["loss"], abs=1e-4)
        assert o["validate"]["acc"] == t["validate"]["acc"]
        assert o["test"]["acc"] == pytest.approx(t["test"]["acc"], abs=1e-4)
        assert o["test"]["per_dataset"] == t["test"]["per_dataset"]
    assert ours.best_epoch == theirs.best_epoch
    assert ours.best_val_acc == theirs.best_val_acc
    assert ours.final_test_acc == pytest.approx(theirs.final_test_acc, abs=1e-4)


def _assert_close(got, want):
    for k, w in want.items():
        if not w.is_floating_point():
            continue
        w = w.numpy()
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-4 * max(np.abs(w).max(), 1.0),
                                   err_msg=k)


def _baseline(opt, **over):
    (jtr, jva, jte), (tr, va, te) = _splits()
    kw = _cfg_kw(optimizer=opt, **over)
    _, params, stats = jax_backbone(H, "emotion", None, WIN, D)
    jm = JaxConv2dBiRNN(hidden_size=H, pred="emotion", dropout_rate=0.0)
    tx = jax_make_optimizer(JaxConfig(**kw), STEPS)
    spk = jax_speaker_weights(jtr)
    jres = jax_fit_device(_jax_state(params, stats, tx), jm, tx, jtr, jva, jte, JaxConfig(**kw),
                          jax_eval_logits_fn(jm), spk_weights=spk, verbose=False)
    model = Conv2dBiRNN(H, D, "emotion", dropout_rate=0.0)
    model.load_state_dict(backbone_state_dict(params, stats))
    cfg = ExperimentConfig(**kw)
    state = init_state(model, make_optimizer(cfg, STEPS, model), device="cpu")
    res = fit_device(state, tr, va, te, cfg, make_eval_logits_fn(model),
                     spk_weights=speaker_weights(tr), verbose=False)
    return res, jres, state


def test_fit_device_matches_jax():
    res, jres, state = _baseline("sgd")
    _assert_history(res, jres)
    assert len(res.history) < 4  # early stopping (patience 1) fired on both sides
    want = backbone_state_dict(jax.tree.map(np.asarray, jres.best_state.params),
                               jax.tree.map(np.asarray, jres.best_state.batch_stats))
    _assert_close(res.best_state["model"], want)
    # the best epoch is not the last: the best state is a snapshot, not the
    # live (final) state
    assert res.best_epoch < len(res.history) - 1
    final = state.model.state_dict()
    assert any(not torch.equal(final[k], v) for k, v in res.best_state["model"].items())
    assert state.model.training


def test_fit_device_adam_plateau_stops_with_jax():
    res, jres, state = _baseline("adam", learning_rate=1e-2, num_epochs=6, plateau_patience=0,
                                 plateau_factor=0.5, early_stop_patience=2)
    assert len(res.history) == len(jres.history) < 6
    assert res.best_epoch == jres.best_epoch
    assert state.optimizer.lr_scale < 1.0  # the plateau scaled the rate


@functools.lru_cache(maxsize=None)
def _noise_fn(jm, train):
    def f(variables, rngs):
        if train:
            return jm.apply(variables, jnp.zeros((1, WIN, D, 1)), train=True, rngs=rngs,
                            mutable=["batch_stats"])[0][-1]
        return jm.apply(variables, jnp.zeros((1, WIN, D, 1)), rngs=rngs)[-1]
    return jax.jit(f)


def _jax_eps(jm, params, stats, rngs, train):
    """The epsilon JAX draws from ``rngs``, (1, WIN, D)."""
    noise = np.asarray(_noise_fn(jm, train)({"params": params, "batch_stats": stats}, rngs))
    scales = np.asarray(jax_cloak_scales(jm, params))
    locs = np.asarray(params["noise"]["locs"])
    return torch.from_numpy((noise[0, :, :, 0] - locs) / scales)[None]


def test_fit_device_cloak_grl_matches_jax():
    (jtr, jva, jte), (tr, va, te) = _splits()
    kw = _cfg_kw(scale_lambda=0.1, grl=True, lr_sched_steps_per_epoch=1, num_epochs=4,
                 early_stop_patience=10)
    _, pe, se = jax_backbone(H, "emotion", None, WIN, D)
    _, pg, sg = jax_backbone(H, "gender", None, WIN, D, seed=1)
    rng = np.random.default_rng(7)
    noise = {"locs": (0.1 * rng.standard_normal((WIN, D))).astype(np.float32),
             "rhos": (-2 + 0.5 * rng.standard_normal((WIN, D))).astype(np.float32)}
    params = {"noise": noise, "emotion_backbone": pe, "gender_backbone": pg}
    stats = {"emotion_backbone": se, "gender_backbone": sg}
    jb = lambda pred: JaxConv2dBiRNN(hidden_size=H, pred=pred, dropout_rate=0.0)  # noqa: E731
    jm = JaxCloakedGRL(emotion_backbone=jb("emotion"), gender_backbone=jb("gender"),
                       grl_lambda=0.1, win_len=WIN, n_feats=D)
    prefixes = ("noise", "gender_backbone")
    tx = jax_cloak_optimizer(JaxConfig(**kw), STEPS, params, prefixes)
    jst = _jax_state(params, stats, tx, key=3)

    def eval_logits(p, bs, spec, g=None):
        return jm.apply({"params": p, "batch_stats": bs}, spec,
                        rngs={"noise": jax.random.PRNGKey(0)})[0]

    jres = jax_fit_device_cloak(jst, jm, tx, jtr, jva, jte, JaxConfig(**kw),
                                jax.jit(eval_logits), verbose=False)

    # the draws of every step of every epoch, in the order the scan takes them
    train_eps, key = [], jst.rng
    for _ in range(kw["num_epochs"]):
        draws = []
        for _ in range(STEPS):
            key, n_rng, d_rng = jax.random.split(key, 3)
            draws.append(_jax_eps(jm, params, stats, {"noise": n_rng, "dropout": d_rng}, True))
        train_eps.append(torch.stack(draws))
    eval_eps = _jax_eps(jm, params, stats, {"noise": jax.random.PRNGKey(0)}, False)

    tb = lambda pred: Conv2dBiRNN(H, D, pred, dropout_rate=0.0)  # noqa: E731
    model = CloakedModelGRL(tb("emotion"), tb("gender"), grl_lambda=0.1, win_len=WIN, n_feats=D)
    model.load_state_dict(cloaked_grl_state_dict(params, stats))
    cfg = ExperimentConfig(**kw)
    state = init_state(model, make_cloak_optimizer(cfg, STEPS, model, prefixes), device="cpu")
    snaps, modes = [], []

    def callback(st):
        snaps.append(copy.deepcopy(st.model.state_dict()))
        modes.append((st.model.training, st.model.emotion_backbone.training,
                      st.model.gender_backbone.training))
        return {}

    res = fit_device_cloak(state, tr, va, te, cfg,
                           make_eval_logits_fn(model, eps=eval_eps, mask=None),
                           verbose=False, epoch_callback=callback, eps=train_eps)
    _assert_history(res, jres)
    want = cloaked_grl_state_dict(jax.tree.map(np.asarray, jres.best_state.params),
                                  jax.tree.map(np.asarray, jres.best_state.batch_stats))
    _assert_close(res.best_state["model"], want)
    # after every validation pass and test vote the model trains again, its
    # frozen emotion backbone in eval mode
    assert modes == [(True, False, True)] * len(res.history)
    best = snaps[res.best_epoch]
    assert all(torch.equal(best[k], v) for k, v in res.best_state["model"].items())


def test_early_stopping_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.9, 0.91, 0.8, 0.85, 0.86, 0.87]
    for patience, delta in ((1, 0.0), (2, 0.0), (3, 0.05)):
        ours, theirs = EarlyStopping(patience, delta), JaxEarlyStopping(patience, delta)
        for v in losses:
            assert ours(v) == theirs(v)
            assert (ours.best, ours.counter) == (theirs.best, theirs.counter)


def test_speaker_weights_match_jax():
    rng = np.random.default_rng(3)
    n = 200
    arrays = _arrays(n, 4)
    arrays["speaker_ids"] = np.array([f"s{k}" for k in rng.integers(0, 7, n)], object)
    arrays["datasets"] = np.array(["iemocap", "crema-d", "msp-improv"], object)[
        rng.choice(3, n, p=[0.7, 0.25, 0.05])]
    ours, theirs = speaker_weights(SplitArrays(**arrays)), jax_speaker_weights(JaxSplit(**arrays))
    assert ours == theirs and max(ours.values()) > 1.0


def test_fold_entry_points_need_cuda_and_refuse_global_feature(monkeypatch, tmp_path):
    """``run_fold`` and ``CheckpointManager.restore`` run on ``device="cuda"``
    unless asked for the CPU, and raise without a card.  The global feature,
    once refused here, now trains: ``run_fold`` with ``global_feature``
    saves a baseline whose ``dense1`` takes the pooled width plus 88."""
    from sept_tpu_torch.cli.train_baseline import run_fold
    from sept_tpu_torch.data.pipeline import FoldData
    from sept_tpu_torch.train.checkpoint import CheckpointManager

    _, (tr, va, te) = _splits()
    fold = FoldData(1, tr, va, tr, va, te)
    ckpt = CheckpointManager(str(tmp_path))
    res = run_fold(ExperimentConfig(**_cfg_kw(global_feature=True, num_epochs=1)), fold, ckpt,
                   verbose=False, device="cpu")
    assert np.isfinite(res.history[0]["train"]["loss"])
    assert ckpt.restore("baseline_emotion", 1, "cpu")["dense1.weight"].shape == (128, 2 * H + 88)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        run_fold(ExperimentConfig(**_cfg_kw()), fold, ckpt, verbose=False)
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.restore("baseline_emotion", 1)
