"""The port's bf16 GRU (``bigru_layer_lowp``) vs flax's
``nn.Bidirectional(nn.RNN(nn.GRUCell(dtype=bfloat16)), ...)`` (CPU).

flax's bf16 cell rounds each gate Dense's input, kernel and bias to bf16 and
returns bf16, computes the gate sums, sigmoid and tanh in bf16, keeps an f32
carry and promotes ``(1 - z) * n + z * h`` to f32.  XLA on the CPU adds two
effects of its own: under its default excess precision it skips bf16
roundings inside fused chains, and its bf16 logistic is not the rounded
sigmoid (it matches the rounded value on 62% of a grid of inputs).  So:

- with ``--xla_allow_excess_precision=false`` (set in a subprocess, since
  the flag is read once per process) and flax's ``gate_fn`` /
  ``activation_fn`` computed in f32 and rounded once, flax and the port
  agree within 1e-6 (reading 6e-8: the f32 carry update in another order);
  a GRU whose carry is bf16, as cuDNN's bf16 GRU keeps it, is at least 1e-3
  away from the same flax output, so the test sees the carry's precision;
- against stock flax under the default flags the port is within 0.03 at
  the max and 3e-3 on average, on outputs up to ~1 (readings 0.0117 and
  1.45e-3; flax's own f32 cell is 0.0091 and 1.7e-3 from its bf16 cell).
"""

import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu_torch.compat.from_jax import _gru_direction
from sept_tpu_torch.models import Conv2dBiRNN
from sept_tpu_torch.models.backbone import bigru_layer_lowp

B, T, F, H = 3, 25, 64, 16

_STRICT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp, flax.linen as fnn
bf, f32 = jnp.bfloat16, jnp.float32
rounded = lambda f: (lambda v: f(v.astype(f32)).astype(v.dtype))
cell = lambda: fnn.GRUCell({H}, dtype=bf, gate_fn=rounded(jax.nn.sigmoid),
                           activation_fn=rounded(jnp.tanh))
layer = fnn.Bidirectional(fnn.RNN(cell()), fnn.RNN(cell()))
d = dict(np.load(sys.argv[1]))
params = {{"forward_rnn": {{"cell": {{}}}}, "backward_rnn": {{"cell": {{}}}}}}
for k, v in d.items():
    if k != "x":
        direction, gate, kind = k.split("/")
        params[direction]["cell"].setdefault(gate, {{}})[kind] = v
np.save(sys.argv[2], np.asarray(layer.apply({{"params": params}}, jnp.asarray(d["x"]))))
""".format(H=H)


def _layer_params(seed=0):
    """(x, flax params of one bidirectional layer, the port's weights)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, F)).astype(np.float32)
    cell = lambda: fnn.GRUCell(H, dtype=jnp.bfloat16)  # noqa: E731
    layer = fnn.Bidirectional(fnn.RNN(cell()), fnn.RNN(cell()))
    v = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
                          .astype(np.float32), v)
    # the port's tensors of each direction, by the weight carry-over's mapping
    weights = [torch.from_numpy(np.ascontiguousarray(_gru_direction(
        params[d]["cell"])[kind])) for d in ("forward_rnn", "backward_rnn")
        for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    return x, params, layer, weights


def test_bf16_gru_is_flax_cell_semantics(tmp_path):
    x, params, _, weights = _layer_params()
    flat = {f"{d}/{g}/{k}": v for d in ("forward_rnn", "backward_rnn")
            for g, kv in params[d]["cell"].items() for k, v in kv.items()}
    np.savez(tmp_path / "in.npz", x=x, **flat)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false"}
    subprocess.run([sys.executable, "-c", _STRICT, str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npy")], check=True, env=env, timeout=300)
    want = np.load(tmp_path / "out.npy")
    got = bigru_layer_lowp(torch.from_numpy(x), weights, torch.bfloat16)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, 2 * H)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    # a bf16 carry (cuDNN's bf16 GRU keeps one) is visibly another function
    h0 = torch.zeros(2, B, H, dtype=torch.bfloat16)
    bf16_carry = torch._VF.gru(torch.from_numpy(x).to(torch.bfloat16), h0,
                               [w.to(torch.bfloat16) for w in weights], True, 1, 0.0, False,
                               True, True)[0].float().numpy()
    assert np.abs(bf16_carry - want).max() >= 1e-3


def test_bf16_gru_near_stock_flax():
    x, params, layer, weights = _layer_params()
    want = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    assert want.dtype == np.float32  # flax's bf16 cell returns its f32 carry
    got = bigru_layer_lowp(torch.from_numpy(x), weights, torch.bfloat16).numpy()
    d = np.abs(got - want)
    assert d.max() <= 0.03 and d.mean() <= 3e-3


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_bf16_backbone_runs_the_lowp_gru_and_keeps_f32_state(train):
    """A bf16 Conv2dBiRNN strict-loads an f32 state_dict, keeps its
    parameters and running statistics f32, and returns f32 logits."""
    f32 = Conv2dBiRNN(hidden_size=H, feature_len=32, dropout_rate=0.0)
    m = Conv2dBiRNN(hidden_size=H, feature_len=32, dropout_rate=0.0,
                    compute_dtype=torch.bfloat16)
    m.load_state_dict(f32.state_dict(), strict=True)
    m.train(train)
    out = m(torch.randn(2, 1, 16, 32, generator=torch.Generator().manual_seed(0)))
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 4)
    assert all(v.dtype == torch.float32 for k, v in m.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    assert torch.isfinite(out).all()
