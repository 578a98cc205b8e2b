"""PyTorch port's Conv2dBiRNN (eval) vs the JAX model, weights carried over
by sept_tpu_torch.compat.from_jax (CPU, logits atol 1e-4)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu_torch.compat.from_jax import backbone_state_dict
from sept_tpu.models import pooling_for as jax_pooling_for
from sept_tpu_torch.models import (Conv2dBiRNN, DeepConv2dBiRNN, OneDConvNet, PlainConv2d,
                                   build_backbone, pooling_for)
from sept_tpu_torch.models.backbone import flatten_channel_major

from _torch_helpers import jax_backbone

CASES = [
    # (hidden, pred, att, batch, win, d)
    (8, "emotion", None, 3, 60, 32),
    (8, "gender", None, 2, 60, 32),
    (8, "multitask", "self_att", 3, 60, 32),
    (8, "emotion", "self_att", 2, 44, 24),
    (64, "emotion", None, 2, 200, 128),  # full width
]


def _port(hidden, pred, att, d, params, stats):
    m = Conv2dBiRNN(hidden_size=hidden, feature_len=d, pred=pred, att=att)
    m.load_state_dict(backbone_state_dict(params, stats))
    return m.eval()


@pytest.mark.parametrize("hidden,pred,att,b,win,d", CASES)
def test_logits_match_jax(hidden, pred, att, b, win, d):
    model, params, stats = jax_backbone(hidden, pred, att, win, d)
    x = np.random.default_rng(5).standard_normal((b, win, d, 1)).astype(np.float32)
    want = model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x))
    port = _port(hidden, pred, att, d, params, stats)
    with torch.inference_mode():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    if pred == "multitask":
        assert isinstance(got, tuple) and len(got) == 2
        pairs = zip(got, want)
    else:
        pairs = [(got, want)]
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_flatten_is_channel_major():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    out = flatten_channel_major(x)  # NCHW (B, C, T, D) -> (B, T, C*D)
    assert out.shape == (2, 4, 15)
    assert torch.equal(out[1, 2, 5:10], x[1, 1, 2])


def test_model_zoo_and_train_mode_refusals():
    assert isinstance(build_backbone("cnn-lstm-att", hidden_size=8), Conv2dBiRNN)
    assert pooling_for("2d-cnn-lstm") == "mean"
    assert pooling_for("deep-2d-cnn-lstm") is None
    # every JAX --model_type builds, each with the JAX package's pooling
    for name, cls, pooling in (("deep-2d-cnn-lstm", DeepConv2dBiRNN, None),
                               ("1d-cnn-lstm-att", OneDConvNet, "mean"),
                               ("2d-cnn", PlainConv2d, "mean")):
        assert type(build_backbone(name, hidden_size=8)) is cls
        assert pooling_for(name) == jax_pooling_for(name) == pooling
    with pytest.raises(ValueError, match="unknown model_type"):
        build_backbone("transformer")
    m = Conv2dBiRNN(hidden_size=8, feature_len=32)
    # train mode runs (tests/test_torch_train.py) but never draws dropout
    # masks from torch's global generator
    with pytest.raises(ValueError, match="DropoutDraws"):
        m.train()(torch.zeros(1, 1, 60, 32))
