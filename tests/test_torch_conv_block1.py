"""First conv block of the PyTorch port vs the JAX package (CPU).

The port's wrappers take their plain versions on CPU tensors; the CUDA
kernels themselves are held against those plain versions on the card by
chip_smoke.py.  The JAX side is the pure-jnp oracle ``block1_reference``
(the interpret-mode Pallas kernels are too slow at 200 x 128 for this lane).
Tolerances are tests/test_pallas_conv.py's: pooled 1e-4, moments rel 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops.pallas_conv import block1_reference
from sept_tpu_torch.ops.conv_block1 import (
    block1_conv_stats,
    block1_conv_stats_plain,
    block1_eval,
    block1_norm_pool,
    block1_norm_pool_plain,
    block1_train_forward,
)

C = 32
GEOMETRIES = [(2, 200, 128), (3, 24, 20), (2, 9, 7)]


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
    )


def _torch_args(d):
    t = torch.from_numpy
    return (t(d["x"]).permute(0, 3, 1, 2).contiguous(),
            t(d["k"]).permute(3, 2, 0, 1).contiguous(), t(d["bias"]))


def _jax_conv(d):
    return jax.lax.conv_general_dilated(
        jnp.asarray(d["x"]), jnp.asarray(d["k"]), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")) + d["bias"]


def _nchw(a):
    return np.transpose(np.asarray(a), (0, 3, 1, 2))


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_block1_eval_matches_reference(geom):
    d = _data(*geom)
    x, k, b = _torch_args(d)
    t = torch.from_numpy
    ours = block1_eval(x, k, b, t(d["gamma"]), t(d["beta"]), t(d["mean"]),
                       t(d["var"])).numpy()
    ref = block1_reference(*(jnp.asarray(d[n]) for n in
                             ("x", "k", "bias", "gamma", "beta", "mean", "var")))
    assert ours.shape == (geom[0], C, geom[1] // 2, geom[2] // 2)
    np.testing.assert_allclose(ours, _nchw(ref), atol=1e-4)


@pytest.mark.parametrize("geom", GEOMETRIES)
def test_conv_stats_moments_match_jnp(geom):
    d = _data(*geom, seed=1)
    y, sums = block1_conv_stats(*_torch_args(d))
    ref = _jax_conv(d)
    np.testing.assert_allclose(y.numpy(), _nchw(ref), atol=1e-5)
    n = geom[0] * geom[1] * geom[2]
    mean = sums[0].numpy() / n
    var = sums[1].numpy() / n - mean * mean
    np.testing.assert_allclose(mean, np.asarray(ref.mean((0, 1, 2))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var, np.asarray(ref.var((0, 1, 2))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("geom", GEOMETRIES[:2])
def test_train_forward_matches_batch_stat_bn(geom):
    """block1_train_forward normalizes with the batch's own moments, as the
    JAX package's ``_train_fwd``."""
    d = _data(*geom, seed=2)
    x, k, b = _torch_args(d)
    t = torch.from_numpy
    pooled, mean, var = block1_train_forward(x, k, b, t(d["gamma"]), t(d["beta"]))
    y = _jax_conv(d)
    rm, rv = y.mean((0, 1, 2)), y.var((0, 1, 2))
    ref = block1_reference(jnp.asarray(d["x"]), jnp.asarray(d["k"]),
                           jnp.asarray(d["bias"]), jnp.asarray(d["gamma"]),
                           jnp.asarray(d["beta"]), rm, rv)
    np.testing.assert_allclose(pooled.numpy(), _nchw(ref), atol=1e-4)
    np.testing.assert_allclose(mean.numpy(), np.asarray(rm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(rv), rtol=1e-5, atol=1e-6)


def test_norm_pool_floors_odd_sizes_and_handles_negative_scale():
    """A negative BN scale flips which element of a window is largest: the
    affine map must be applied before the max, then ReLU."""
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal((2, 3, 7, 9)).astype(np.float32))
    scale = torch.tensor([1.5, -2.0, 0.5])
    shift = torch.tensor([0.1, 0.0, -0.3])
    out = block1_norm_pool(y, scale, shift)
    assert out.shape == (2, 3, 3, 4)
    z = np.maximum(y.numpy() * scale.numpy()[:, None, None]
                   + shift.numpy()[:, None, None], 0.0)[:, :, :6, :8]
    want = z.reshape(2, 3, 3, 2, 4, 2).max((3, 5))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-6)


def test_wrappers_take_plain_versions_only_on_cpu():
    d = _data(2, 12, 10)
    x, k, b = _torch_args(d)
    y, sums = block1_conv_stats(x, k, b)
    y2, sums2 = block1_conv_stats_plain(x, k, b)
    assert torch.equal(y, y2) and torch.equal(sums, sums2)
    s = torch.ones(C)
    assert torch.equal(block1_norm_pool(y, s, s), block1_norm_pool_plain(y, s, s))
    with pytest.raises(ValueError, match="no kernel for meta"):
        block1_conv_stats(x.to("meta"), k.to("meta"), b.to("meta"))
    with pytest.raises(ValueError, match="no kernel for meta"):
        block1_norm_pool(y.to("meta"), s.to("meta"), s.to("meta"))


def test_shape_checks():
    x = torch.zeros(2, 1, 8, 8)
    with pytest.raises(ValueError, match=r"\(C, 1, 5, 5\)"):
        block1_conv_stats(x, torch.zeros(4, 1, 3, 3), torch.zeros(4))
    with pytest.raises(ValueError, match=r"\(B, 1, H, W\)"):
        block1_conv_stats(torch.zeros(2, 2, 8, 8), torch.zeros(4, 1, 5, 5),
                          torch.zeros(4))
    with pytest.raises(ValueError, match="scale and shift"):
        block1_norm_pool(torch.zeros(2, 4, 8, 8), torch.zeros(3), torch.zeros(4))
