"""On-device ingest and device-resident splits of the PyTorch port vs the JAX
package (CPU).

``device_ingest`` runs the port's mel chain (the plain version of the mel
kernel on the CPU) and per-speaker z-norm against ``_ingest`` with
``frontend="xla"``.  Signals have a broadband floor (``speechlike``), where
the two f32 mel chains agree within 1e-3 dB; after normalization by the
per-speaker std the windows are held within 1e-4.  Labels, weights and the
split padding are exact.
"""

import numpy as np
import pytest
import torch

from sept_tpu.data.device_pipeline import device_ingest as jax_device_ingest
from sept_tpu.data.pipeline import SplitArrays
from sept_tpu.train.device_loop import DeviceSplit as JaxDeviceSplit
from sept_tpu.train.device_loop import _spk_weight_vec as jax_spk_weight_vec
from sept_tpu_torch.data.device_pipeline import device_ingest
from sept_tpu_torch.train.device_loop import DeviceSplit, _spk_weight_vec

from _torch_helpers import speechlike

N_MELS, WIN, SHIFT = 32, 20, 5


@pytest.mark.parametrize("seconds,pcm", [
    ((0.15, 0.5, 0.31, 0.22, 0.4), False),   # shorter and longer than a window
    ((0.1, 0.15, 0.12), True),               # all shorter: frames padded to one window
], ids=["mixed", "short-pcm16"])
def test_device_ingest_matches_jax(seconds, pcm):
    rng = np.random.default_rng(0)
    waves = [speechlike(rng, int(s * 16000)) for s in seconds]
    if pcm:
        waves = [(w * 20000).astype(np.int16) for w in waves]
    n = len(waves)
    spk = np.arange(n) % 3
    le, lg = np.arange(n) % 4, (np.arange(n) // 2) % 2
    want = jax_device_ingest(waves, spk, le, lg, n_mels=N_MELS, win_len=WIN, shift_len=SHIFT)
    got = device_ingest(waves, spk, le, lg, n_mels=N_MELS, win_len=WIN, shift_len=SHIFT,
                        device="cpu")
    assert got.windows.shape == want.windows.shape
    np.testing.assert_allclose(got.windows.numpy(), np.asarray(want.windows), atol=1e-4)
    np.testing.assert_array_equal(got.labels_emo.numpy(), np.asarray(want.labels_emo))
    np.testing.assert_array_equal(got.labels_gen.numpy(), np.asarray(want.labels_gen))
    np.testing.assert_array_equal(got.weight.numpy(), np.asarray(want.weight))
    assert 0 < float(got.weight.sum()) <= len(got)
    idx = torch.tensor([0, len(got) - 1, 1])
    batch = got.batch(idx)
    assert batch["spec"].shape == (3, 1, WIN, N_MELS)
    assert torch.equal(batch["spec"][:, 0], got.windows[idx])


def _split(n, seed=0):
    rng = np.random.default_rng(seed)
    return SplitArrays(
        windows=rng.standard_normal((n, 6, 4)).astype(np.float32),
        labels_emo=(np.arange(n) % 4).astype(np.int32),
        labels_gen=(np.arange(n) % 2).astype(np.int32),
        lengths=np.full(n, 6, np.int32),
        global_data=np.zeros((n, 88), np.float32),
        speaker_ids=np.array([f"s{i % 3}" for i in range(n)], dtype=object),
        datasets=np.array(["iemocap"] * n, dtype=object),
        utt_ids=np.array([f"u{i}" for i in range(n)], dtype=object))


@pytest.mark.parametrize("n,label_key", [(10, "labels_emo"), (8, "labels_gen")])
def test_device_split_pads_with_row_zero_at_weight_zero(n, label_key):
    split = _split(n)
    extra = _spk_weight_vec(split, {"s1_iemocap": 2.0})
    np.testing.assert_array_equal(extra, jax_spk_weight_vec(split, {"s1_iemocap": 2.0}))
    assert _spk_weight_vec(split, None) is None
    want = JaxDeviceSplit(split, label_key, batch_size=4, extra_weights=extra)
    got = DeviceSplit(split, label_key, batch_size=4, extra_weights=extra, device="cpu")
    for name in ("windows", "labels_emo", "labels_gen", "labels", "weights"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert (got.n_real, got.n_batches, got.batch_size) == (n, want.n_batches, 4)
    assert torch.equal(got.windows[n:], got.windows[:1].expand(len(got.windows) - n, -1, -1))
