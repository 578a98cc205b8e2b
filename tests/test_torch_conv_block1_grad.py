"""Block 1's backward in the PyTorch port (K3-K5 and the autograd Functions)
vs jax.grad of the jnp oracles (CPU).

The port's wrappers take their plain versions on CPU tensors; chip_smoke.py
holds the CUDA kernels against those on the card.  Oracles: the batch-stat
block of tests/test_pallas_conv.py for train mode, ``block1_reference`` for
eval mode (the interpret-mode Pallas kernels are the JAX suite's slow lane).
Tolerance: forward 1e-4, every gradient 1e-4 * max(|ref|, 1), except the
train-mode db: a bias ahead of batch-statistics BN has gradient 0 in exact
arithmetic, and both sides return f32 cancellation noise of a sum over
B * H * W terms (readings at (2, 200, 128): port 3.1e-4, JAX 1.7e-3).  Each
is held to that zero within B * H * W * 2^-24, one f32 rounding unit a term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops.pallas_conv import block1_reference
from sept_tpu_torch.ops import conv_block1 as K

C, EPS = 32, 1e-5
GEOMETRIES = [(2, 200, 128), (3, 24, 20), (2, 9, 7)]
NAMES = ("dx", "dW", "db", "dgamma", "dbeta")


def _data(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((b, h, w, 1)).astype(np.float32),
        k=(rng.standard_normal((5, 5, 1, C)) * 0.2).astype(np.float32),
        bias=(rng.standard_normal(C) * 0.1).astype(np.float32),
        gamma=(1 + 0.1 * rng.standard_normal(C)).astype(np.float32),
        beta=(0.1 * rng.standard_normal(C)).astype(np.float32),
        mean=(0.1 * rng.standard_normal(C)).astype(np.float32),
        var=(1 + 0.5 * rng.random(C)).astype(np.float32),
        cot=rng.standard_normal((b, h // 2, w // 2, C)).astype(np.float32),
    )


def _jax_train(x, k, bias, gamma, beta):
    y = jax.lax.conv_general_dilated(
        x, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
    mean = y.mean((0, 1, 2))
    var = ((y - mean) ** 2).mean((0, 1, 2))
    z = jax.nn.relu((y - mean) * jax.lax.rsqrt(var + EPS) * gamma + beta)
    return jax.lax.reduce_window(z, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                 (1, 2, 2, 1), "VALID")


def _torch_leaves(d):
    t = torch.from_numpy
    return [t(d["x"]).permute(0, 3, 1, 2).contiguous().requires_grad_(),
            t(d["k"]).permute(3, 2, 0, 1).contiguous().requires_grad_(),
            t(d["bias"]).requires_grad_(), t(d["gamma"]).requires_grad_(),
            t(d["beta"]).requires_grad_()]


def _to_torch_layout(name, g):
    g = np.asarray(g)
    if name == "dx":
        return np.transpose(g, (0, 3, 1, 2))
    if name == "dW":
        return np.transpose(g, (3, 2, 0, 1))
    return g


def _check(grads, ref_grads, n_train=None):
    for name, g, r in zip(NAMES, grads, ref_grads):
        r = _to_torch_layout(name, r)
        if name == "db" and n_train:
            bound = n_train * 2.0 ** -24
            assert np.abs(g.numpy()).max() <= bound and np.abs(r).max() <= bound
            continue
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * max(np.abs(r).max(), 1.0),
                                   err_msg=name)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_block1_train_matches_jax_grad(geom):
    d = _data(*geom)
    args = [jnp.asarray(d[n]) for n in ("x", "k", "bias", "gamma", "beta")]
    ref = _jax_train(*args)
    ref_grads = jax.grad(lambda *a: jnp.sum(_jax_train(*a) * d["cot"]),
                         argnums=(0, 1, 2, 3, 4))(*args)
    leaves = _torch_leaves(d)
    pooled, mean, var = K.Block1Train.apply(*leaves, EPS)
    assert not mean.requires_grad and not var.requires_grad
    np.testing.assert_allclose(pooled.detach().numpy(),
                               np.transpose(np.asarray(ref), (0, 3, 1, 2)), atol=1e-4)
    cot = torch.from_numpy(d["cot"]).permute(0, 3, 1, 2)
    _check(torch.autograd.grad((pooled * cot).sum(), leaves), ref_grads,
           n_train=geom[0] * geom[1] * geom[2])


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_block1_eval_matches_jax_grad(geom):
    d = _data(*geom, seed=1)
    args = [jnp.asarray(d[n]) for n in ("x", "k", "bias", "gamma", "beta")]
    stats = (jnp.asarray(d["mean"]), jnp.asarray(d["var"]))
    ref_grads = jax.grad(
        lambda *a: jnp.sum(block1_reference(*a, *stats) * d["cot"]),
        argnums=(0, 1, 2, 3, 4))(*args)
    leaves = _torch_leaves(d)
    pooled = K.Block1Eval.apply(*leaves, torch.from_numpy(d["mean"]),
                                torch.from_numpy(d["var"]), EPS)
    cot = torch.from_numpy(d["cot"]).permute(0, 3, 1, 2)
    _check(torch.autograd.grad((pooled * cot).sum(), leaves), ref_grads)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("x_grad,params_grad,want", [
    (False, True, {"k3", "k4"}),          # a baseline step: x is data
    (True, False, {"k3", "k5"}),          # a frozen backbone under the cloak
    (True, True, {"k3", "k4", "k5"}),     # the GRL gender branch
], ids=["baseline", "frozen", "both"])
def test_backward_launches_only_what_is_needed(monkeypatch, train, x_grad, params_grad,
                                               want):
    called = set()
    for tag, name in (("k3", "block1_route"), ("k4", "block1_weight_grads"),
                      ("k5", "block1_input_grad")):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _tag=tag: (called.add(_tag),
                                                                    _fn(*a))[1])
    d = _data(2, 12, 10, seed=2)
    leaves = _torch_leaves(d)
    leaves[0].requires_grad_(x_grad)
    for p in leaves[1:]:
        p.requires_grad_(params_grad)
    if train:
        pooled = K.block1_train_forward(*leaves)[0]
    else:
        pooled = K.block1_eval(*leaves, torch.from_numpy(d["mean"]),
                               torch.from_numpy(d["var"]))
    grads = torch.autograd.grad(pooled.sum(), [t for t in leaves if t.requires_grad])
    assert called == want
    assert all(torch.isfinite(g).all() for g in grads)


def test_first_max_routing_on_ties():
    """Ties go to the first maximum in row-major order, the ReLU gradient is 0
    where BN output <= 0, and an odd last row / column gets no gradient:
    as jax.grad through relu + reduce_window (select-and-scatter)."""
    y = torch.tensor([[2.0, 2.0, 1.0, 3.0, -1.0, -2.0, 0.0, 0.0, 9.0],
                      [2.0, 2.0, 3.0, 0.0, -3.0, -4.0, 5.0, 5.0, 9.0],
                      [0.5, 0.5, 0.0, 0.0, 4.0, 4.0, 7.0, 1.0, 9.0],
                      [0.5, 0.5, 0.0, 0.0, 4.0, 1.0, 7.0, 7.0, 9.0],
                      [9.0, 9.0, 9.0, 9.0, 9.0, 9.0, 9.0, 9.0, 9.0]])[None, None]
    cot = torch.arange(1.0, 9.0).reshape(1, 1, 2, 4)
    one, zero = torch.ones(1), torch.zeros(1)
    dy, sums = K.block1_route(y, cot, one, zero, zero, one)
    want = torch.zeros_like(y)
    # windows, row-major: (0,0) all 2 -> top-left; (0,1) 1,3/3,0 -> first 3;
    # (0,2) all negative -> none; (0,3) 0,0/5,5 -> first 5; (1,0) all 0.5;
    # (1,1) all 0 -> none (ReLU gradient 0 at 0); (1,2) 4,4/4,1; (1,3) 7,1/7,7
    for (h, w), g in (((0, 0), 1), ((0, 3), 2), ((1, 6), 4), ((2, 0), 5),
                      ((2, 4), 7), ((2, 6), 8)):
        want[0, 0, h, w] = g
    assert torch.equal(dy, want)
    assert torch.equal(sums, torch.stack([want.sum((0, 2, 3)),
                                          (want * y).sum((0, 2, 3))]))

    yj = jnp.asarray(np.transpose(y.numpy(), (0, 2, 3, 1)))
    cj = jnp.asarray(np.transpose(cot.numpy(), (0, 2, 3, 1)))
    ref = jax.grad(lambda t: jnp.sum(jax.lax.reduce_window(
        jax.nn.relu(t), -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID") * cj))(yj)
    np.testing.assert_array_equal(dy.numpy(), np.transpose(np.asarray(ref), (0, 3, 1, 2)))


@pytest.mark.parametrize("name", ["block1_route", "block1_weight_grads",
                                  "block1_input_grad"])
def test_backward_wrappers_refuse_a_device_without_a_kernel(name):
    """The plain version is taken for a CPU tensor only; any other device
    launches the kernel (CUDA) or raises."""
    d = _data(1, 9, 7, seed=3)
    x, k, _, gamma, beta = (t.detach() for t in _torch_leaves(d))
    y = torch.nn.functional.conv2d(x, k, padding=2)
    mean, var = torch.from_numpy(d["mean"]), torch.from_numpy(d["var"])
    ga, shift = K.fold_bn(gamma, beta, mean, var)
    inv, m = torch.rsqrt(var + EPS), torch.zeros(C)
    cot = torch.from_numpy(d["cot"]).permute(0, 3, 1, 2).contiguous()
    dy = torch.zeros_like(y)
    args = {"block1_route": (y, cot, ga, shift, mean, inv),
            "block1_weight_grads": (x, y, dy, ga, mean, inv, m, m),
            "block1_input_grad": (y, dy, k, ga, mean, inv, m, m)}[name]
    with pytest.raises(ValueError, match="no kernel for meta"):
        getattr(K, name)(*(a.to("meta") for a in args))
