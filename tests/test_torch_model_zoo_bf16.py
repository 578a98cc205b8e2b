"""The port's bf16 LSTM vs the JAX package's (CPU).

- the bf16 LSTM's step loop (``bilstm_layer_lowp``) against flax's
  ``OptimizedLSTMCell(dtype=bfloat16)``, as tests/test_torch_gru_bf16.py
  holds the GRU's: within 1e-6 of flax under
  ``--xla_allow_excess_precision=false`` (set in a subprocess) with its
  gates computed in f32 and rounded once (reading 1.2e-7: the f32 carry in
  another order), within 0.03 at the max and 3e-3 on average of stock flax
  (readings 4.9e-3 and 6.4e-4; flax's own f32 cell is 4.4e-3 and 6.9e-4 from
  its bf16 cell), and an LSTM whose carry is bf16 (cuDNN's bf16 LSTM keeps
  one) at least 1e-3 from the same flax output (reading 4.2e-3);
- the bf16 deep LSTM model (hidden 16, B = 2, 200 x 128 windows, dropout
  0) against the JAX package's eager ``DeepConv2dBiRNN(rnn_cell="lstm",
  dtype=bfloat16, conv_backend="fused1")`` at
  tests/test_torch_backbone_bf16.py's bounds and for its reasons: logits
  within 0.02 of max(|logits|, 0.1) (reading 2.4e-3 on logits up to 0.40),
  running statistics after the train-mode forward within 5e-4 * max(|s|,
  1) (reading 2.0e-4), gradients within max(0.05 * max |g|, 0.02)
  (readings: at most 0.0116, for block 2's conv bias, whose gradient is 0
  in exact arithmetic ahead of batch-stat BN; 0.0087 for conv.0.weight, of
  max |g| 0.199).  The fused block takes 200 x 128 windows only; with
  the JAX model's XLA block 1 instead, block 3's running variance lies
  1.0e-3 away on 40 x 32 windows, past the bound the port keeps to the fused
  block.
"""

import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import torch

from sept_tpu.models import build_backbone as jax_build_backbone
from sept_tpu.models import compute_dtype as jax_compute_dtype
from sept_tpu_torch.compat.from_jax import _lstm_direction, backbone_state_dict
from sept_tpu_torch.models import build_backbone, compute_dtype
from sept_tpu_torch.models.backbone import bilstm_layer_lowp

from _torch_helpers import jax_zoo

WIN, D = 200, 128


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


_STRICT = r"""
import sys
import numpy as np, jax, jax.numpy as jnp, flax.linen as fnn
bf, f32 = jnp.bfloat16, jnp.float32
rounded = lambda f: (lambda v: f(v.astype(f32)).astype(v.dtype))
cell = lambda: fnn.OptimizedLSTMCell({H}, dtype=bf, gate_fn=rounded(jax.nn.sigmoid),
                                     activation_fn=rounded(jnp.tanh))
layer = fnn.Bidirectional(fnn.RNN(cell()), fnn.RNN(cell()))
d = dict(np.load(sys.argv[1]))
params = {{"forward_rnn": {{"cell": {{}}}}, "backward_rnn": {{"cell": {{}}}}}}
for k, v in d.items():
    if k != "x":
        direction, gate, kind = k.split("/")
        params[direction]["cell"].setdefault(gate, {{}})[kind] = v
np.save(sys.argv[2], np.asarray(layer.apply({{"params": params}}, jnp.asarray(d["x"]))))
"""


def test_bf16_lstm_is_flax_cell_semantics(tmp_path):
    b, t, f, h = 3, 25, 64, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, t, f)).astype(np.float32)
    cell = lambda: fnn.OptimizedLSTMCell(h, dtype=jnp.bfloat16)  # noqa: E731
    layer = fnn.Bidirectional(fnn.RNN(cell()), fnn.RNN(cell()))
    v = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape))
                          .astype(np.float32), v)
    weights = [torch.from_numpy(np.ascontiguousarray(_lstm_direction(
        params[d]["cell"])[kind])) for d in ("forward_rnn", "backward_rnn")
        for kind in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    flat = {f"{d}/{g}/{k}": val for d in ("forward_rnn", "backward_rnn")
            for g, kv in params[d]["cell"].items() for k, val in kv.items()}
    np.savez(tmp_path / "in.npz", x=x, **flat)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_allow_excess_precision=false"}
    subprocess.run([sys.executable, "-c", _STRICT.format(H=h), str(tmp_path / "in.npz"),
                    str(tmp_path / "out.npy")], check=True, env=env, timeout=300)
    strict = np.load(tmp_path / "out.npy")
    got = bilstm_layer_lowp(torch.from_numpy(x), weights, torch.bfloat16)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, t, 2 * h)
    got = got.numpy()
    np.testing.assert_allclose(got, strict, atol=1e-6)
    stock = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    d = np.abs(got - stock)
    assert d.max() <= 0.03 and d.mean() <= 3e-3
    h0 = torch.zeros(2, b, h, dtype=torch.bfloat16)
    bf16_carry = torch._VF.lstm(torch.from_numpy(x).to(torch.bfloat16), (h0, h0),
                                [w.to(torch.bfloat16) for w in weights], True, 1, 0.0, False,
                                True, True)[0].float().numpy()
    assert np.abs(bf16_carry - strict).max() >= 1e-3


def test_bf16_deep_lstm_matches_jax():
    win = WIN
    _, params, stats = jax_zoo("deep-2d-cnn-lstm", 16, "emotion", None, win, D, rnn_cell="lstm")
    jm = jax_build_backbone("deep-2d-cnn-lstm", hidden_size=16, rnn_cell="lstm",
                            dropout_rate=0.0, dtype=jax_compute_dtype("bfloat16"),
                            conv_backend="fused1")
    port = build_backbone("deep-2d-cnn-lstm", hidden_size=16, feature_len=D, win_len=win,
                          rnn_cell="lstm", dropout_rate=0.0,
                          compute_dtype=compute_dtype("bfloat16"))
    port.load_state_dict(backbone_state_dict(params, stats), strict=True)
    x = np.random.default_rng(5).standard_normal((2, win, D, 1)).astype(np.float32)
    labels = np.arange(2) % 4

    def loss(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                            pooling=None, mutable=["batch_stats"])
        return -jnp.mean(jax.nn.log_softmax(out)[jnp.arange(2), labels]), (out, mut)

    (_, (want, mut)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    got = port.train()(_nchw(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=0.02 * max(float(jnp.abs(want).max()), 0.1))
    new_stats = jax.tree.map(np.asarray, mut["batch_stats"])
    sd = backbone_state_dict(params, new_stats)
    for k, v in port.state_dict().items():
        if "running" in k:
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(),
                                       atol=5e-4 * max(float(sd[k].abs().max()), 1.0), err_msg=k)
    (-torch.log_softmax(got, -1)[torch.arange(2), torch.from_numpy(labels)].mean()).backward()
    want_g = backbone_state_dict(jax.tree.map(np.asarray, grads), new_stats)
    for k, p in port.named_parameters():
        w = want_g[k].numpy()
        if p.grad is None:  # the pinned bias_ih, which the bf16 loop does not read
            assert ".bias_ih" in k and not w.any(), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, atol=max(0.05 * np.abs(w).max(), 0.02),
                                   err_msg=k)
