"""Training Conv2dBiRNN in the PyTorch port vs the JAX package (CPU).

Dropout is 0 on both sides (torch's and JAX's generators cannot give the
same masks) and both start from the same perturbed weights, carried over by
sept_tpu_torch.compat.from_jax; the batches and their order are the same.
Tolerances: train-mode logits and running statistics 1e-5 * max(|ref|, 1);
per-step losses 1e-5 relative; SGD parameters after 3 steps 1e-5 *
max(|p|, 1).  Adam's m / sqrt(v) turns the f32 noise of a gradient near 0
into a step of up to lr, on either side.  The conv biases ahead of
batch-stat BN have gradient 0 in exact arithmetic (reading: 6.1e-5 apart
after 3 steps at lr 1e-3), and the BN running mean after each takes 0.1 of
its offset a step (reading: 1.4e-5); entries of other tensors can have
near-zero gradients too (reading: conv.10.weight 7.7e-6 apart).  So under
Adam every tensor is held within 3 * lr (3 steps), and all but the biases
and running means above must also have 99% of their entries within the
SGD bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.models import Conv2dBiRNN as JaxConv2dBiRNN
from sept_tpu.train import ExperimentConfig as JaxConfig
from sept_tpu.train import make_baseline_step as jax_baseline_step
from sept_tpu.train import make_epoch_runner as jax_epoch_runner
from sept_tpu.train import make_optimizer as jax_make_optimizer
from sept_tpu.train.steps import TrainState as JaxState
from sept_tpu_torch.compat.from_jax import backbone_state_dict
from sept_tpu_torch.models import Conv2dBiRNN
from sept_tpu_torch.models.backbone import DropoutDraws
from sept_tpu_torch.train.config import ExperimentConfig
from sept_tpu_torch.train.optim import make_optimizer
from sept_tpu_torch.train.steps import init_state, make_baseline_step, make_epoch_runner

from _torch_helpers import jax_backbone

H, WIN, D, B = 8, 40, 16, 8
# conv biases ahead of batch-stat BN, and the running means that follow them
ADAM_DRIFT = ("conv.0.bias", "conv.5.bias", "conv.10.bias", "conv.1.running_mean",
              "conv.6.running_mean", "conv.11.running_mean")


def _nchw(spec):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(spec, (0, 3, 1, 2))))


def _port(params, stats, pred="emotion", att=None):
    m = Conv2dBiRNN(hidden_size=H, feature_len=D, pred=pred, att=att, dropout_rate=0.0)
    m.load_state_dict(backbone_state_dict(params, stats))
    return m


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [dict(spec=rng.standard_normal((B, WIN, D, 1)).astype(np.float32),
                 labels_emo=rng.integers(0, 4, B).astype(np.int32),
                 labels_gen=rng.integers(0, 2, B).astype(np.int32),
                 weight=np.r_[np.ones(B - 2), np.zeros(2)].astype(np.float32))
            for _ in range(n)]


def _torch_batch(b):
    return {"spec": _nchw(b["spec"]), "labels_emo": torch.from_numpy(b["labels_emo"]).long(),
            "labels_gen": torch.from_numpy(b["labels_gen"]).long(),
            "weight": torch.from_numpy(b["weight"])}


def _cfg_kw(opt):
    return dict(optimizer=opt, learning_rate=1e-2 if opt == "sgd" else 1e-3,
                weight_decay=1e-4)


def _assert_state_matches(model, jparams, jstats, adam_lr=None):
    want = backbone_state_dict(jax.tree.map(np.asarray, jparams),
                               jax.tree.map(np.asarray, jstats))
    got = model.state_dict()
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        w, g = w.numpy(), got[k].detach().numpy()
        atol = 1e-5 * max(np.abs(w).max(), 1.0)
        if adam_lr:
            np.testing.assert_allclose(g, w, atol=3 * adam_lr, err_msg=k)
            if k not in ADAM_DRIFT:
                assert np.mean(np.abs(g - w) > atol) <= 0.01, k
        else:
            np.testing.assert_allclose(g, w, atol=atol, err_msg=k)


@pytest.mark.parametrize("pred,att", [("emotion", None), ("multitask", "self_att")])
def test_train_forward_matches_jax(pred, att):
    _, params, stats = jax_backbone(H, pred, att, WIN, D)
    x = np.random.default_rng(2).standard_normal((B, WIN, D, 1)).astype(np.float32)
    jm = JaxConv2dBiRNN(hidden_size=H, pred=pred, att=att, dropout_rate=0.0)
    want, mut = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                         train=True, mutable=["batch_stats"])
    port = _port(params, stats, pred, att).train()
    got = port(_nchw(x))
    for g, w in zip(got if pred == "multitask" else [got],
                    want if pred == "multitask" else [want]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-5 * max(np.abs(w).max(), 1))
    _assert_state_matches(port, params, mut["batch_stats"])


@pytest.mark.parametrize("opt,pred", [("sgd", "emotion"), ("adam", "emotion"),
                                      ("sgd", "multitask")])
def test_baseline_steps_match_jax(opt, pred):
    _, params, stats = jax_backbone(H, pred, None, WIN, D)
    tx = jax_make_optimizer(JaxConfig(**_cfg_kw(opt)), 100)
    st = JaxState(params=params, batch_stats=stats, opt_state=tx.init(params),
                  rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))
    jstep = jax_baseline_step(JaxConv2dBiRNN(hidden_size=H, pred=pred, dropout_rate=0.0), tx)
    model = _port(params, stats, pred)
    state = init_state(model, make_optimizer(ExperimentConfig(**_cfg_kw(opt)), 100, model),
                       device="cpu")
    step = make_baseline_step()
    for b in _batches(3):
        st, jm = jstep(st, {**{k: jnp.asarray(v) for k, v in b.items()},
                            "global": jnp.zeros((B, 88))})
        state, m = step(state, _torch_batch(b))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(m["correct"]) == float(jm["correct"])
        assert float(m["count"]) == float(jm["count"]) == B - 2
    assert state.step == 3 and state.optimizer.count == 3
    _assert_state_matches(model, st.params, st.batch_stats,
                          adam_lr=1e-3 if opt == "adam" else None)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_epoch_runner_matches_jax(opt):
    _, params, stats = jax_backbone(H, "emotion", None, WIN, D)
    rng = np.random.default_rng(3)
    m_rows, n_batches = 3 * B, 3
    windows = rng.standard_normal((m_rows, WIN, D)).astype(np.float32)
    labels = (np.arange(m_rows) % 4).astype(np.int32)
    weights = np.ones(m_rows, np.float32)
    weights[-3:] = 0.0
    order = rng.permutation(m_rows)
    tx = jax_make_optimizer(JaxConfig(**_cfg_kw(opt)), n_batches)
    st = JaxState(params=params, batch_stats=stats, opt_state=tx.init(params),
                  rng=jax.random.PRNGKey(0), step=jnp.zeros((), jnp.int32))
    run = jax_epoch_runner(JaxConv2dBiRNN(hidden_size=H, dropout_rate=0.0), tx)
    st, jl, jc, jn = run(st, jnp.asarray(windows), jnp.asarray(labels), jnp.asarray(weights),
                         jnp.asarray(order), n_batches=n_batches, batch_size=B)

    model = _port(params, stats)
    state = init_state(model, make_optimizer(ExperimentConfig(**_cfg_kw(opt)), n_batches,
                                             model), device="cpu")
    state, losses, correct, counts = make_epoch_runner()(
        state, torch.from_numpy(windows), torch.from_numpy(labels).long(),
        torch.from_numpy(weights), order, n_batches=n_batches, batch_size=B)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5)
    np.testing.assert_array_equal(correct.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jn))
    _assert_state_matches(model, st.params, st.batch_stats,
                          adam_lr=1e-3 if opt == "adam" else None)


def test_gru_bias_hh_rz_rows_stay_pinned():
    """flax's GRUCell has one r and one z bias (carried in bias_ih): the
    bias_hh r/z rows get no gradient and stay 0 under SGD with weight decay,
    while their n rows and the other biases move."""
    _, params, stats = jax_backbone(H, "emotion", None, WIN, D)
    model = _port(params, stats)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = init_state(model, make_optimizer(ExperimentConfig(**_cfg_kw("sgd")), 10, model),
                       device="cpu")
    step = make_baseline_step()
    for b in _batches(3, seed=4):
        step(state, _torch_batch(b))
    for name, p in model.rnn.named_parameters():
        if name.startswith("bias_hh"):
            assert torch.equal(p[:2 * H], torch.zeros(2 * H)), name
            assert torch.equal(p.grad[:2 * H], torch.zeros(2 * H)), name
            assert not torch.equal(p[2 * H:], before[f"rnn.{name}"][2 * H:]), name
        if name.startswith("bias_ih"):
            assert not torch.equal(p[:2 * H], before[f"rnn.{name}"][:2 * H]), name


def test_channel_dropout_masks_and_replay():
    """A (B, C, 1, 1) mask after each conv block, kept with 1 - rate and
    scaled by 1 / (1 - rate); a replay reuses the same masks."""
    rate = 0.5
    model = Conv2dBiRNN(hidden_size=H, feature_len=D, dropout_rate=rate).train()
    draws = DropoutDraws(torch.Generator().manual_seed(0))
    x = torch.randn(16, 1, WIN, D, generator=torch.Generator().manual_seed(1))
    out = model(x, dropout=draws)
    shapes = [tuple(m.shape) for m in draws._masks]
    assert shapes[:3] == [(16, 32, 1, 1), (16, 64, 1, 1), (16, 128, 1, 1)]
    assert shapes[3] == (16, WIN // 8, 2 * H) and shapes[4] == (16, 128)
    kept = torch.cat([m.flatten() for m in draws._masks]).float().mean()
    assert 0.4 < float(kept) < 0.6
    z = torch.ones(16, 32, 4, 4)
    keep = draws._masks[0]
    y = model._dropout(z, draws.replay(), (16, 32, 1, 1))
    assert torch.equal(y, torch.where(keep, z / (1 - rate), torch.zeros_like(z)))
    assert set(torch.unique(y).tolist()) <= {0.0, 1 / (1 - rate)}
    stats = [b.clone() for b in model.buffers()]
    again = model(x, dropout=draws.replay(), update_stats=False)
    assert all(torch.equal(a, b) for a, b in zip(stats, model.buffers()))
    # the same masks, and the same batch moments: the same logits
    torch.testing.assert_close(again, out, rtol=0, atol=0)
    with pytest.raises(ValueError, match="DropoutDraws"):
        model(x)
