"""The saliency-alignment term of the cloak + GRL game in the PyTorch port vs
the JAX package (CPU, f32).

``saliency_alignment_loss`` alone (its value within 1e-5 of the scale of
its terms, its gradient in the noise's ``rhos`` within 1e-5 of the max),
then three ``make_cloak_grl_step`` steps (single and antithetic)
and one ``make_cloak_epoch_runner`` epoch with ``saliency_align`` > 0, at
the small f32 shapes and tolerances of tests/test_torch_cloak_train.py
(losses 1e-5 relative, trained parameters 1e-5 * max(|p|, 1)).  The bf16
GRL step with the term is in tests/test_torch_train_bf16.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.train.steps import make_cloak_epoch_runner as jax_cloak_runner
from sept_tpu.train.steps import make_cloak_grl_step as jax_grl_step
from sept_tpu.train.steps import saliency_alignment_loss as jax_saliency_alignment_loss
from sept_tpu_torch.ops import conv_block1 as K
from sept_tpu_torch.train.steps import (
    make_cloak_epoch_runner,
    make_cloak_grl_step,
    saliency_alignment_loss,
)

from test_torch_cloak_train import (
    B,
    D,
    GENDER_LAMBDA,
    SCALE_LAMBDA,
    WIN,
    _assert_trained_state,
    _batches,
    _jax_eps,
    _setup,
    _torch_batch,
)

SALIENCY = 0.5


def test_saliency_alignment_loss_matches_jax(monkeypatch):
    jm, _, jst, state = _setup(grl=True)
    b = _batches(1, seed=4)[0]
    args = [jnp.asarray(b[k]) for k in ("spec", "labels_emo", "labels_gen", "weight")]

    def term(rhos):
        params = {**jst.params, "noise": {**jst.params["noise"], "rhos": rhos}}
        return jax_saliency_alignment_loss(jm, params, jst.batch_stats, *args)

    rhos = jnp.asarray(jst.params["noise"]["rhos"])
    want, want_grad = jax.jit(jax.value_and_grad(term))(rhos)
    model = state.model.train()
    calls = []
    for name in ("block1_weight_grads", "block1_input_grad"):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _n=name: (calls.append(_n), _fn(*a))[1])
    tb = _torch_batch(b)
    got = saliency_alignment_loss(model, tb["spec"], tb["labels_emo"], tb["labels_gen"],
                                  tb["weight"])
    # the saliencies are input gradients only (K5 in each branch, never K4),
    # in eval mode, and the model's modes are as they were
    assert calls == ["block1_input_grad", "block1_input_grad"]
    assert model.gender_backbone.training and not model.emotion_backbone.training
    got.backward()
    # the term is a difference of two unit-mean saliencies under the scales:
    # held to 1e-5 of the scale of its terms, mean(scales * (sal_e + sal_g))
    # ~ 2 mean(scales), not of its value (4e-4 here, 5e-4 apart relative)
    scale = 2 * float(model.noise.scales().detach().mean())
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * scale
    w = np.asarray(want_grad)
    np.testing.assert_allclose(model.noise.rhos.grad[0].numpy(), w,
                               atol=1e-5 * np.abs(w).max())
    assert model.noise.locs.grad is None or not model.noise.locs.grad.any()
    assert all(p.grad is None for p in model.gender_backbone.parameters())


@pytest.mark.parametrize("antithetic", [False, True], ids=["single", "antithetic"])
def test_cloak_grl_step_with_saliency_matches_jax(antithetic):
    jm, tx, jst, state = _setup(grl=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    kw = dict(scale_lambda=SCALE_LAMBDA, gender_lambda=GENDER_LAMBDA, antithetic=antithetic,
              saliency_align=SALIENCY)
    jstep, step = jax_grl_step(jm, tx, **kw), make_cloak_grl_step(**kw)
    for b in _batches(3):
        _, n_rng, d_rng = jax.random.split(jst.rng, 3)
        eps = _jax_eps(jm, jst, n_rng, d_rng)
        jst, jmet = jstep(jst, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, _torch_batch(b), eps=eps)
        assert float(m["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
        assert float(m["gender_correct"]) == float(jmet["gender_correct"])
    _assert_trained_state(state.model, before, jst, grl=True)


def test_cloak_epoch_runner_with_saliency_matches_jax():
    jm, tx, jst, state = _setup(grl=True)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    n_batches, rows = 2, 2 * B
    rng = np.random.default_rng(6)
    windows = rng.standard_normal((rows, WIN, D)).astype(np.float32)
    le = (np.arange(rows) % 4).astype(np.int32)
    lg = (np.arange(rows) % 2).astype(np.int32)
    w = np.ones(rows, np.float32)
    order = rng.permutation(rows)
    eps, key = [], jst.rng
    for _ in range(n_batches):
        key, n_rng, d_rng = jax.random.split(key, 3)
        eps.append(_jax_eps(jm, jst, n_rng, d_rng))
    kw = dict(scale_lambda=SCALE_LAMBDA, gender_lambda=GENDER_LAMBDA, grl=True,
              saliency_align=SALIENCY)
    jst, jl, _, _ = jax_cloak_runner(jm, tx, **kw)(
        jst, jnp.asarray(windows), jnp.asarray(le), jnp.asarray(lg), jnp.asarray(w),
        jnp.asarray(order), None, n_batches=n_batches, batch_size=B)
    t = torch.from_numpy
    state, losses, _, _ = make_cloak_epoch_runner(**kw)(
        state, t(windows), t(le).long(), t(lg).long(), t(w), order, None,
        n_batches=n_batches, batch_size=B, eps=torch.stack(eps))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jl), rtol=1e-5)
    _assert_trained_state(state.model, before, jst, grl=True)
