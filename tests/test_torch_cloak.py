"""The port's CloakNoise vs the JAX CloakNoise (CPU).

torch's and JAX's generators give different numbers from one seed, so the
JAX draw is recovered from the JAX layer's output and injected into the
port: eps = (out - x - locs) / scales at a mask of ones (eps already carries
the 0.1 std).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.models import CloakNoise as JaxCloakNoise
from sept_tpu_torch.compat.from_jax import cloak_noise_state_dict
from sept_tpu_torch.models import CloakNoise

WIN, D = 60, 32


def _pair(max_scale, seed=0):
    rng = np.random.default_rng(seed)
    p = {"locs": (0.2 * rng.standard_normal((WIN, D))).astype(np.float32),
         "rhos": rng.uniform(-3.0, 2.0, (WIN, D)).astype(np.float32)}
    jax_layer = JaxCloakNoise(win_len=WIN, n_feats=D, max_scale=max_scale)
    port = CloakNoise(win_len=WIN, n_feats=D, max_scale=max_scale)
    port.load_state_dict(cloak_noise_state_dict(p))
    return p, jax_layer, port


@pytest.mark.parametrize("max_scale", [10.0, 5.0])
def test_scales_match(max_scale):
    p, jax_layer, port = _pair(max_scale)
    want = jax_layer.apply({"params": p}, method=JaxCloakNoise.scales)
    np.testing.assert_allclose(port.scales().detach().numpy()[0], np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mask_kind", ["none", "ones", "binary"])
def test_injected_draw_matches_jax(mask_kind):
    p, jax_layer, port = _pair(5.0, seed=1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, WIN, D)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    v = {"params": p}
    ones = jnp.ones((WIN, D))
    probe = np.asarray(jax_layer.apply(v, jnp.asarray(x), ones, rngs={"noise": key}))
    scales = np.asarray(jax_layer.apply(v, method=JaxCloakNoise.scales))
    eps = torch.from_numpy((probe[0] - x[0] - p["locs"]) / scales)[None]

    mask = {"none": None, "ones": np.ones((WIN, D), np.float32),
            "binary": (rng.random((WIN, D)) > 0.4).astype(np.float32)}[mask_kind]
    want = jax_layer.apply(v, jnp.asarray(x), None if mask is None else jnp.asarray(mask),
                           rngs={"noise": key})
    with torch.no_grad():
        got = port(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask),
                   eps=eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_mask_gates_input_and_eps_but_not_locs():
    p, _, port = _pair(5.0)
    x = torch.randn(3, WIN, D, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = port(x, torch.zeros(WIN, D), generator=torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(out.numpy(), np.broadcast_to(p["locs"], (3, WIN, D)))


def test_generator_draw_is_seeded_with_std_point_one():
    port = CloakNoise(win_len=WIN, n_feats=D, max_scale=5.0)
    with torch.no_grad():
        port.rhos.fill_(20.0)  # scales == max_scale
        a = port.sample_noise(generator=torch.Generator().manual_seed(3))
        b = port.sample_noise(generator=torch.Generator().manual_seed(3))
        c = port.sample_noise(generator=torch.Generator().manual_seed(4))
        neg = port.sample_noise(sign=-1.0, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(neg, -a)  # antithetic pair (locs are 0)
    assert abs(float(a.std()) / 5.0 - 0.1) < 0.01
    with pytest.raises(ValueError, match="Generator"):
        port.sample_noise()
