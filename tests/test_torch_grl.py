"""The port's gradient-reversal layer vs sept_tpu.ops.grl (CPU, exact: the
forward is the identity and the backward one multiply)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops.grl import gradient_reversal as jax_grl
from sept_tpu_torch.ops.grl import gradient_reversal


@pytest.mark.parametrize("lam", [0.1, 1.0, 2.5])
def test_gradient_reversal_matches_jax(lam):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)
    w = rng.standard_normal((3, 7, 5)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jax_grl(t, lam) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    y = gradient_reversal(xt, lam)
    assert torch.equal(y.detach(), xt.detach())
    (g,) = torch.autograd.grad((y * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
