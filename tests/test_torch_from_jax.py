"""Weight carry-over: the port's state_dicts equal the JAX package's own
export to the reference layout, bit for bit."""

import numpy as np
import pytest
import torch

from sept_tpu.compat import export_backbone, export_cloak_noise
from sept_tpu_torch.compat.from_jax import backbone_state_dict, cloak_noise_state_dict
from sept_tpu_torch.models import CloakNoise, Conv2dBiRNN

from _torch_helpers import jax_backbone


@pytest.mark.parametrize("pred,att", [("emotion", None), ("gender", None),
                                      ("multitask", "self_att")])
def test_backbone_state_dict_equals_export(pred, att):
    _, params, stats = jax_backbone(8, pred, att)
    ours = backbone_state_dict(params, stats)
    ref = export_backbone({"params": params, "batch_stats": stats})
    for key, t in ours.items():
        want = ref[key]
        assert t.numpy().dtype == want.dtype, key
        np.testing.assert_array_equal(t.numpy(), want, err_msg=key)
    # exactly the tensors the port's module declares: strict load
    m = Conv2dBiRNN(hidden_size=8, feature_len=32, pred=pred, att=att)
    assert set(ours) == set(m.state_dict())
    m.load_state_dict(ours)
    # the GRU's r/z biases live wholly in bias_ih
    h = 8
    assert not ours["rnn.bias_hh_l0"][: 2 * h].any()


def test_cloak_noise_state_dict_equals_export():
    rng = np.random.default_rng(0)
    p = {"locs": rng.standard_normal((60, 32)).astype(np.float32),
         "rhos": rng.standard_normal((60, 32)).astype(np.float32)}
    ours = cloak_noise_state_dict(p)
    ref = export_cloak_noise(p)
    assert set(ours) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(ours[key].numpy(), ref[key])
    CloakNoise(win_len=60, n_feats=32).load_state_dict(ours)
    assert ours["locs"].dtype == torch.float32
