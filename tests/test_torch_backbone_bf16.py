"""The port's bf16 Conv2dBiRNN vs the JAX package's
``Conv2dBiRNN(dtype=bfloat16, conv_backend="fused1")`` (CPU).

Hidden 16, B = 2, 200 x 128 windows (the fused block's geometry), dropout
0, weights carried over by sept_tpu_torch.compat.from_jax; the JAX model
runs eagerly (``apply`` outside ``jit``, its block 1 in the interpret-mode
Pallas kernels), so XLA's excess precision over fused bf16 chains stays out
of it (under ``jit`` the JAX model's own block-2 running variance moves by
1.5e-3 after one forward, against 2.3e-5 between the port and the eager
model).  Tolerances, tighter than or equal to tests/test_pallas_conv.py's
between the JAX package's two bf16 backends: logits within 0.02 of
max(|logits|, 0.1) in train and eval mode (readings 3.8e-3 and 3.3e-3, on
logits up to 0.66 in eval mode; the stock bf16 GRU alone accounts for that,
tests/test_torch_gru_bf16.py); running statistics after a train-mode forward within 5e-4 * max(|s|,
1) (reading 7.6e-5); parameter gradients within max(0.05 * max |g|, 0.02)
(readings: at most 0.0055, for the block-2 and block-3 conv biases, whose
gradient is 0 in exact arithmetic ahead of batch-stat BN and bf16 noise on
both sides; 0.0030 for conv.0.weight, of max |g| 0.106).  Each bf16 gradient of the
port is 2-5x closer to JAX's bf16 gradient than either is to the f32 one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.models import Conv2dBiRNN as JaxConv2dBiRNN
from sept_tpu.models import compute_dtype as jax_compute_dtype
from sept_tpu_torch.compat.from_jax import backbone_state_dict
from sept_tpu_torch.models import build_backbone, compute_dtype

from _torch_helpers import jax_backbone

H, WIN, D, B = 16, 200, 128, 2


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
def test_compute_dtype_names_the_jax_package_s(name):
    """The --compute_dtype values map to the dtype the JAX package picks."""
    want = jax_compute_dtype(name) or jnp.float32
    assert str(compute_dtype(name)).removeprefix("torch.") == jnp.dtype(want).name
    m = build_backbone("2d-cnn-lstm", hidden_size=8, compute_dtype=compute_dtype(name))
    assert m.compute_dtype == compute_dtype(name)


def _models():
    _, params, stats = jax_backbone(H, "emotion", None, WIN, D)
    jm = JaxConv2dBiRNN(hidden_size=H, pred="emotion", dropout_rate=0.0,
                        dtype=jax_compute_dtype("bfloat16"), conv_backend="fused1")
    port = build_backbone("2d-cnn-lstm", hidden_size=H, feature_len=D, dropout_rate=0.0,
                          compute_dtype=compute_dtype("bfloat16"))
    port.load_state_dict(backbone_state_dict(params, stats), strict=True)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    return jm, params, stats, port


def test_bf16_model_matches_jax():
    jm, params, stats, port = _models()
    x = np.random.default_rng(5).standard_normal((B, WIN, D, 1)).astype(np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    labels = np.arange(B) % 4

    def loss(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return -jnp.mean(jax.nn.log_softmax(out)[jnp.arange(B), labels]), (out, mut)

    (_, (want, mut)), grads = jax.value_and_grad(loss, has_aux=True)(params)
    port.train()
    got = port(xt)
    assert got.dtype == torch.float32
    scale = max(float(jnp.abs(want).max()), 0.1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=0.02 * scale)
    sd = backbone_state_dict(params, jax.tree.map(np.asarray, mut["batch_stats"]))
    for k, v in port.state_dict().items():
        if "running" in k:
            assert v.dtype == torch.float32
            np.testing.assert_allclose(v.numpy(), sd[k].numpy(),
                                       atol=5e-4 * max(float(sd[k].abs().max()), 1.0),
                                       err_msg=k)

    (-torch.log_softmax(got, -1)[torch.arange(B), torch.from_numpy(labels)].mean()).backward()
    want_g = backbone_state_dict(jax.tree.map(np.asarray, grads), stats)
    for k, p in port.named_parameters():
        w = want_g[k].numpy()  # bias_hh's r, z rows: 0 on both sides
        assert p.grad.dtype == torch.float32
        np.testing.assert_allclose(p.grad.numpy(), w,
                                   atol=max(0.05 * np.abs(w).max(), 0.02), err_msg=k)

    port.eval()  # with the running statistics the train-mode forward left
    want_eval = np.asarray(jm.apply({"params": params, "batch_stats": mut["batch_stats"]},
                                    jnp.asarray(x)))
    with torch.inference_mode():
        got_eval = port(xt)
    np.testing.assert_allclose(got_eval.numpy(), want_eval,
                               atol=0.02 * max(float(np.abs(want_eval).max()), 0.1))
