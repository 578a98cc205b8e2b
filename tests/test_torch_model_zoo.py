"""The port's model zoo vs the JAX package's (CPU): DeepConv2dBiRNN (GRU and
LSTM), Conv2dBiRNN with an LSTM, OneDConvNet (flatten and attention) and
PlainConv2d, weights carried over by sept_tpu_torch.compat.from_jax.

- eval logits within 1e-4 (as tests/test_torch_backbone.py);
- one train-mode forward and backward, dropout 0 on both sides: the loss
  within 1e-5 relative, every parameter gradient and running statistic
  within 1e-5 * max(|ref|, 1) (tests/test_torch_train.py's bound on
  train-mode outputs and statistics).

The bf16 LSTM is held in tests/test_torch_model_zoo_bf16.py.  Also:

- the factory's knob dropping (a port of
  tests/test_models.py::test_build_backbone_accepts_full_trainer_knob_set),
  the deep model's pooling through a step, an epoch and the eval forward (a
  port of tests/test_epoch_runner.py::test_deep_model_pooling_consistent_
  train_eval), and a deep-model sweep through SweepModel with flatten
  pooling against the JAX package's vote.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.eval.sliding import make_sliding_vote_fn as jax_vote_fn
from sept_tpu.models import build_backbone as jax_build_backbone
from sept_tpu_torch.compat.from_jax import backbone_state_dict
from sept_tpu_torch.data.pipeline import SplitArrays
from sept_tpu_torch.eval import sweep as S
from sept_tpu_torch.models import (Conv2dBiRNN, DeepConv2dBiRNN, OneDConvNet, PlainConv2d,
                                   build_backbone, pooling_for)
from sept_tpu_torch.train.config import ExperimentConfig
from sept_tpu_torch.train.optim import make_optimizer
from sept_tpu_torch.train.steps import (init_state, make_baseline_step, make_epoch_runner,
                                        make_eval_logits_fn, weighted_ce)

from _torch_helpers import jax_zoo

H, D, B = 8, 32, 3
# (model_type, rnn_cell, pred, att, win): OneDConvNet pools by 2 * 5 * 5
CASES = [("deep-2d-cnn-lstm", "gru", "emotion", None, 40),
         ("deep-2d-cnn-lstm", "lstm", "gender", None, 40),
         ("deep-2d-cnn-lstm", "gru", "multitask", "self_att", 40),
         ("2d-cnn-lstm", "lstm", "emotion", None, 40),
         ("1d-cnn-lstm-att", "gru", "emotion", None, 100),
         ("1d-cnn-lstm-att", "gru", "multitask", "self_att", 100),
         ("2d-cnn", "gru", "emotion", None, 40)]
IDS = ["deep_gru", "deep_lstm_gender", "deep_att_multitask", "lstm", "one_d",
       "one_d_att_multitask", "plain"]


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _port(model_type, rnn_cell, pred, att, win, params, stats, **kw):
    m = build_backbone(model_type, hidden_size=H, feature_len=D, win_len=win, pred=pred, att=att,
                       rnn_cell=rnn_cell, **kw)
    m.load_state_dict(backbone_state_dict(params, stats))
    return m


def _heads(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("model_type,rnn_cell,pred,att,win", CASES, ids=IDS)
def test_eval_logits_match_jax(model_type, rnn_cell, pred, att, win):
    jm, params, stats = jax_zoo(model_type, H, pred, att, win, D, rnn_cell=rnn_cell)
    x = np.random.default_rng(5).standard_normal((B, win, D, 1)).astype(np.float32)
    pooling = pooling_for(model_type)
    want = jax.jit(lambda v, x: jm.apply(v, x, pooling=pooling))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x))
    port = _port(model_type, rnn_cell, pred, att, win, params, stats).eval()
    with torch.inference_mode():
        got = port(_nchw(x), pooling=pooling)
    assert len(_heads(got)) == (2 if pred == "multitask" and model_type != "2d-cnn" else 1)
    for g, w in zip(_heads(got), _heads(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("model_type,rnn_cell,pred,att,win", CASES, ids=IDS)
def test_train_step_grads_and_stats_match_jax(model_type, rnn_cell, pred, att, win):
    _, params, stats = jax_zoo(model_type, H, pred, att, win, D, rnn_cell=rnn_cell)
    jm = jax_build_backbone(model_type, hidden_size=H, pred=pred, att=att, rnn_cell=rnn_cell,
                            dropout_rate=0.0)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((B, win, D, 1)).astype(np.float32)
    labels = rng.integers(0, 2, B)
    pooling = pooling_for(model_type)

    def loss_fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                            pooling=pooling, mutable=["batch_stats"])
        return sum(-jnp.mean(jax.nn.log_softmax(o)[jnp.arange(B), labels])
                   for o in _heads(out)), mut

    (want_loss, mut), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = _port(model_type, rnn_cell, pred, att, win, params, stats, dropout_rate=0.0).train()
    ones = torch.ones(B)
    loss = sum(weighted_ce(o, torch.from_numpy(labels), ones)
               for o in _heads(port(_nchw(x), pooling=pooling)))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    new_stats = jax.tree.map(np.asarray, mut.get("batch_stats", {}))
    want_g = backbone_state_dict(jax.tree.map(np.asarray, grads), new_stats)
    for k, p in port.named_parameters():
        w = want_g[k].numpy()  # the pinned bias rows: 0 on both sides
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-5 * max(np.abs(w).max(), 1.0),
                                   err_msg=k)
    want_sd = backbone_state_dict(params, new_stats)
    running = [k for k in port.state_dict() if "running" in k]
    assert len(running) == 2 * sum(1 for k in want_sd if k.endswith("running_mean"))
    for k in running:
        w = want_sd[k].numpy()
        np.testing.assert_allclose(port.state_dict()[k].numpy(), w,
                                   atol=1e-5 * max(np.abs(w).max(), 1.0), err_msg=k)


def test_build_backbone_accepts_full_trainer_knob_set():
    """Every --model_type builds under the trainers' full knob set: the
    family's knobs are dropped where the class lacks them (JAX drops
    ``dtype`` for 1d-cnn-lstm-att and 2d-cnn, so their bf16 runs train in
    f32), and any other unknown knob raises."""
    knobs = dict(hidden_size=16, pred="emotion", att=None, attention_size=128,
                 compute_dtype=torch.bfloat16, feature_len=32, win_len=200, rnn_cell="gru")
    classes = {"2d-cnn-lstm": Conv2dBiRNN, "cnn-lstm-att": Conv2dBiRNN,
               "deep-2d-cnn-lstm": DeepConv2dBiRNN, "1d-cnn-lstm-att": OneDConvNet,
               "2d-cnn": PlainConv2d}
    for mt, cls in classes.items():
        m = build_backbone(mt, **knobs)
        assert type(m) is cls
        assert getattr(m, "compute_dtype", torch.float32) == (
            torch.bfloat16 if "rnn" in dict(m.named_children()) else torch.float32)
        jm = jax_build_backbone(mt, hidden_size=16, dtype=jnp.bfloat16)
        assert hasattr(jm, "dtype") == hasattr(m, "compute_dtype"), mt
    with pytest.raises(TypeError):
        build_backbone("2d-cnn-lstm", hiden_size=16)  # a typo must not vanish
    with pytest.raises(ValueError, match="unknown model_type"):
        build_backbone("no-such-model")


def test_deep_model_pooling_consistent_train_eval():
    """The deep model flattens the RNN sequence: the step, the epoch runner
    and the eval forward all take pooling=None, and dense1's width fits."""
    win = 40
    model = build_backbone("deep-2d-cnn-lstm", hidden_size=H, feature_len=D, win_len=win)
    state = init_state(model, make_optimizer(ExperimentConfig(learning_rate=1e-3), 10, model),
                       device="cpu")
    batch = {"spec": torch.zeros(4, 1, win, D), "labels_emo": torch.zeros(4, dtype=torch.long),
             "labels_gen": torch.zeros(4, dtype=torch.long), "weight": torch.ones(4)}
    state, m = make_baseline_step(pooling=None)(state, batch)
    assert np.isfinite(float(m["loss"]))
    logits = make_eval_logits_fn(model, pooling=None)(batch["spec"])
    assert tuple(logits.shape) == (4, 4)
    state, losses, *_ = make_epoch_runner(pooling=None)(
        state, torch.zeros(8, win, D), torch.zeros(8, dtype=torch.long), torch.ones(8),
        np.arange(8), n_batches=2, batch_size=4)
    assert torch.isfinite(losses).all() and state.step == 3
    with pytest.raises(RuntimeError):  # mean pooling gives dense1 the wrong width
        make_eval_logits_fn(model, pooling="mean")(batch["spec"])


def test_deep_model_sweep_with_flatten_pooling():
    """evaluate_cloaked_test over deep emotion and gender models through
    SweepModel (pooling=None) against the JAX package's vote of the same
    noised windows through its deep models."""
    win, shift = 40, 10
    je, pe, se = jax_zoo("deep-2d-cnn-lstm", H, "emotion", None, win, D)
    ja, pa, sa = jax_zoo("deep-2d-cnn-lstm", H, "gender", None, win, D, seed=1)
    rng = np.random.default_rng(7)
    locs = (0.1 * rng.standard_normal((win, D))).astype(np.float32)
    rhos = rng.uniform(-2.5, 0.5, (win, D)).astype(np.float32)
    eps = (0.1 * rng.standard_normal((win, D))).astype(np.float32)
    lengths = np.array([30, 40, 57, 75, 90], np.int32)
    n = len(lengths)
    specs = rng.standard_normal((n, int(lengths.max()), D)).astype(np.float32)
    test = SplitArrays(windows=specs, labels_emo=rng.integers(0, 4, n).astype(np.int32),
                       labels_gen=rng.integers(0, 2, n).astype(np.int32), lengths=lengths,
                       global_data=np.zeros((n, 88), np.float32),
                       speaker_ids=np.array(["s"] * n, object),
                       datasets=np.array(["iemocap"] * n, object),
                       utt_ids=np.array([f"u{i}" for i in range(n)], object))
    model = S.SweepModel(build_backbone("deep-2d-cnn-lstm", hidden_size=H, feature_len=D,
                                        win_len=win, pred="emotion"),
                         build_backbone("deep-2d-cnn-lstm", hidden_size=H, feature_len=D,
                                        win_len=win, pred="gender"),
                         win_len=win, n_feats=D, pooling=pooling_for("deep-2d-cnn-lstm"))
    model.load_cell({"noise.locs": torch.from_numpy(locs[None]),
                     "noise.rhos": torch.from_numpy(rhos[None])},
                    backbone_state_dict(pe, se), backbone_state_dict(pa, sa))
    mask = S.eval_mask(model.noise.scales().detach()[0].numpy(), 40)
    b, a = S.evaluate_cloaked_test(model, test, mask, win_len=win, shift_len=shift,
                                   batch_size=2, eps=torch.from_numpy(eps[None]))
    scales = model.noise.scales().detach()[0].numpy()
    noise = locs + scales * eps * mask

    def joint(_p, _s, wins, _g):
        noised = wins * mask[..., None] + noise[..., None]
        return jnp.concatenate([
            je.apply({"params": pe, "batch_stats": se}, noised, pooling=None),
            ja.apply({"params": pa, "batch_stats": sa}, noised, pooling=None)], -1)

    want = np.asarray(jax_vote_fn(joint, win, shift, head_sizes=(4, 2))(
        None, None, specs, lengths)[0])
    np.testing.assert_allclose(np.concatenate([b["probs"], a["probs"]], -1), want, atol=1e-5)
