"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

The JAX model is initialised from a seed, then every parameter and running
statistic is perturbed with seeded numpy noise, so that no mapping error can
hide behind flax's zero biases or unit running variances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sept_tpu.models import Conv2dBiRNN


def _perturb(tree, rng, scale):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, scale) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    return (a + scale * rng.standard_normal(a.shape)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_backbone(hidden=8, pred="emotion", att=None, win=60, d=32, seed=0):
    """(model, params, batch_stats) of a JAX Conv2dBiRNN as numpy trees,
    shared by the tests of one process (callers must not mutate them)."""
    model = Conv2dBiRNN(hidden_size=hidden, pred=pred, att=att)
    v = jax.jit(model.init)({"params": jax.random.PRNGKey(seed)},
                            jnp.zeros((1, win, d, 1)))
    rng = np.random.default_rng(seed + 100)
    params = _perturb(jax.tree_util.tree_map(np.asarray, v["params"]), rng, 0.05)
    stats = {
        name: {"mean": (0.1 * rng.standard_normal(s["mean"].shape)).astype(np.float32),
               "var": (1.0 + 0.5 * rng.random(s["var"].shape)).astype(np.float32)}
        for name, s in v["batch_stats"].items()
    }
    return model, params, stats


def speechlike(rng, n, noise=0.05):
    """A 16 kHz test signal: two tones over a broadband noise floor.

    The floor keeps every mel band far above f32 rounding: where a band sits
    60 dB under the frame's energy, its dB value is set by the summation
    order of the DFT and two f32 implementations differ by up to ~0.05 dB.
    """
    t = np.arange(n) / 16000.0
    f1, f2 = rng.uniform(100, 400), rng.uniform(800, 3000)
    w = (0.3 * np.sin(2 * np.pi * f1 * t) + 0.1 * np.sin(2 * np.pi * f2 * t)
         + noise * rng.standard_normal(n))
    return w.astype(np.float32)
