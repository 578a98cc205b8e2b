"""PyTorch port's frontend and mel kernel wrapper vs the JAX package (CPU)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops import frontend as JF
from sept_tpu.ops.pallas_frontend import pallas_mel_spectrogram
from sept_tpu_torch.ops import frontend as TF
from sept_tpu_torch.ops import mel as M
from sept_tpu_torch.ops.mel import mel_db, mel_db_plain

from _torch_helpers import speechlike

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "frontend_golden.npz")


def test_constant_tables_are_bit_equal():
    np.testing.assert_array_equal(TF.hann_window(800), JF.hann_window(800))
    for args in ((401, 0.0, 8000.0, 128, 16000), (801, 0.0, 8000.0, 128, 16000),
                 (201, 0.0, 8000.0, 40, 16000, "slaney", "slaney")):
        np.testing.assert_array_equal(TF.melscale_fbanks(*args),
                                      JF.melscale_fbanks(*args))
    for n_fft in (400, 800):
        for a, b in zip(TF.rdft_matrices(n_fft), JF._rdft_matrices(n_fft)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scale", ["htk", "slaney"])
def test_mel_scale_round_trip(scale):
    f = np.linspace(0, 8000, 97)
    np.testing.assert_array_equal(TF.hz_to_mel(f, scale), JF.hz_to_mel(f, scale))
    m = TF.hz_to_mel(f, scale)
    np.testing.assert_array_equal(TF.mel_to_hz(m, scale), JF.mel_to_hz(m, scale))


def test_pcm_to_float_is_exact(rng):
    pcm = rng.integers(-32768, 32768, 5000).astype(np.int16)
    ours = TF.pcm_to_float(torch.from_numpy(pcm)).numpy()
    theirs = np.asarray(JF.pcm_to_float(jnp.asarray(pcm)))
    np.testing.assert_array_equal(ours, theirs)
    f = torch.from_numpy(pcm.astype(np.float32))
    assert TF.pcm_to_float(f) is f


@pytest.mark.parametrize("n_fft,hop,center", [(800, 160, True), (400, 200, True),
                                              (800, 160, False)])
def test_frames_and_power_spectrum(rng, n_fft, hop, center):
    w = speechlike(rng, 6000)
    fr = TF.frame_signal(torch.from_numpy(w), n_fft, hop, center).numpy()
    np.testing.assert_array_equal(
        fr, np.asarray(JF.frame_signal(jnp.asarray(w), n_fft, hop, center)))
    ours = TF.stft_power(torch.from_numpy(w), n_fft, hop, center).numpy()
    theirs = np.asarray(JF.stft_power(jnp.asarray(w), n_fft, hop, center=center))
    assert ours.shape == theirs.shape
    np.testing.assert_allclose(ours, theirs, rtol=1e-4, atol=1e-5 * theirs.max())


@pytest.mark.parametrize("top_db", [None, 80.0])
def test_amplitude_to_db(rng, top_db):
    x = (10.0 ** rng.uniform(-12, 2, (128, 50))).astype(np.float32)
    ours = TF.amplitude_to_db(torch.from_numpy(x), "power", top_db).numpy()
    theirs = np.asarray(JF.amplitude_to_db(jnp.asarray(x), "power", top_db))
    np.testing.assert_allclose(ours, theirs, atol=1e-4)


@pytest.mark.parametrize("n_fft", [800, 1600])
def test_mel_spectrogram_matches_jax(rng, n_fft):
    w = speechlike(rng, 9000)
    ours = TF.mel_spectrogram(torch.from_numpy(w), n_fft=n_fft).numpy()
    theirs = np.asarray(JF.mel_spectrogram(jnp.asarray(w), n_fft=n_fft))
    np.testing.assert_allclose(ours, theirs, atol=1e-3)


@pytest.mark.parametrize("signal", ["tonal", "noisy", "quiet"])
def test_mel_spectrogram_matches_golden(signal):
    g = np.load(_GOLDEN)
    w = torch.from_numpy(g[f"{signal}|wave"])
    for key, n_fft in (("mel1", 800), ("mel2", 1600)):
        ours = TF.mel_spectrogram(w, n_fft=n_fft, hop_length=160, n_mels=128).numpy()
        want = g[f"{signal}|{key}"]
        # the JAX frontend's bound (tests/test_frontend_parity.py) on every
        # cell within 60 dB of the utterance's peak.  Below that the power
        # sits ~1e-7 of the frame's energy, at f32 rounding: the worst
        # reading is 0.0515 dB, one cell of the tonal signal at n_fft 800
        # (frame 7, band 25, -65.4 dB, 101 dB below the peak), where the JAX
        # frontend itself is 0.024 dB off; 1e-1 leaves room for another
        # CPU's summation order
        live = want > want.max() - 60.0
        np.testing.assert_allclose(ours[live], want[live], atol=5e-2)
        np.testing.assert_allclose(ours[~live], want[~live], atol=1e-1)


def _padded_batch(rng, lengths, n_fft=800, tail=0):
    """Reflect-padded rows, zero-padded to a common width plus ``tail``."""
    pad = n_fft // 2
    rows = [np.pad(speechlike(rng, n), (pad, pad), mode="reflect") for n in lengths]
    width = max(len(r) for r in rows) + tail
    out = np.zeros((len(rows), width), np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _jax_serving_mel(padded, n_frames, n_fft=800, n_mels=128):
    """The JAX Predictor's XLA chain (serve.py::Predictor._features)."""
    fb = jnp.asarray(JF.melscale_fbanks(n_fft // 2 + 1, 0.0, 8000.0, n_mels, 16000))
    out = []
    for w in padded:
        spec = JF.stft_power(jnp.asarray(w), n_fft, 160, center=False)
        mel = jnp.dot(spec.T, fb, precision=JF.PARITY_PRECISION)
        out.append(np.asarray(JF.amplitude_to_db(mel.T, "power", None).T)[:n_frames])
    return np.stack(out)


@pytest.mark.parametrize("lengths,tail", [((8000, 5200, 11000), 640), ((16000,), 0)])
def test_mel_db_plain_matches_xla_chain(rng, lengths, tail):
    padded = _padded_batch(rng, lengths, tail=tail)
    t = (padded.shape[1] - 800) // 160 + 1
    ours = mel_db(torch.from_numpy(padded), t).numpy()
    assert ours.shape == (len(lengths), t, 128)
    np.testing.assert_allclose(ours, _jax_serving_mel(padded, t), atol=1e-3)
    if len(lengths) > 1:  # frames past a short utterance's end: the clamp
        assert (ours[int(np.argmin(lengths)), -1] == -100.0).all()


def test_mel_db_plain_matches_pallas_interpret(rng):
    padded = _padded_batch(rng, (9000, 7000))
    t = (padded.shape[1] - 800) // 160 + 1
    ours = mel_db_plain(torch.from_numpy(padded), t).numpy()
    theirs = np.asarray(pallas_mel_spectrogram(jnp.asarray(padded), tile=32,
                                               interpret=True))
    np.testing.assert_allclose(ours, theirs[:, :t], atol=2e-2)


def test_mel_db_frame_count_and_geometry_checks(rng):
    padded = torch.from_numpy(_padded_batch(rng, (4000,)))
    t_all = (padded.shape[1] - 800) // 160 + 1
    full = mel_db(padded, t_all)
    np.testing.assert_allclose(mel_db(padded, 5).numpy(), full[:, :5].numpy(),
                               atol=1e-5)
    with pytest.raises(ValueError, match="samples"):
        mel_db(padded, t_all + 1)
    with pytest.raises(ValueError, match=r"\(B, L\)"):
        mel_db(padded[0], 3)


def test_mel_db_takes_int16_pcm(rng):
    padded = (_padded_batch(rng, (6000, 4000)) * 20000).astype(np.int16)
    t = (padded.shape[1] - 800) // 160 + 1
    ours = mel_db(torch.from_numpy(padded), t)
    want = mel_db(torch.from_numpy(padded.astype(np.float32) / 32768.0), t)
    assert torch.equal(ours, want)


def test_mel_db_refuses_devices_without_a_kernel():
    """Only a CPU tensor takes the plain version; anything that is not a
    CUDA tensor otherwise raises instead of falling back."""
    x = torch.empty((2, 2000), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        mel_db(x, 5)


def test_cached_tables_are_read_only_and_copied_into_tensors():
    """The constant tables are cached for the process: each comes back
    read-only (a caller's in-place write raises instead of changing every
    later user's table), and the mel kernels' tensors own copies of them
    (a ``torch.from_numpy`` CPU tensor would share the cached storage)."""
    tables = (TF.hann_window(1024), *TF.rdft_matrices(1024), TF.create_dct(40, 128),
              TF.melscale_fbanks(513, 0.0, 8000.0, 320, 16000))
    for a in tables:
        assert not a.flags.writeable
        with pytest.raises(ValueError, match="read-only"):
            a[0] = 1.0
    cpu = torch.device("cpu")
    for t in M._tables(1024, 320, cpu) + M._fft_tables(1024, 320, cpu)[1:]:
        assert not any(np.shares_memory(t.numpy(), a) for a in tables)
