"""The port's MFCC half of the frontend, the bf16 mel mode, the floor + DCT
kernel's plain version and ``fused_mfcc`` vs the JAX package (CPU).

The JAX Pallas kernels run in interpret mode at ``tile=32``, as
``tests/test_pallas_frontend.py`` runs them.  bf16 bounds: the port's plain
bf16 chain and JAX's round the same operands at the same six places and
differ only in f32 summation order, which can flip bf16 roundings of the
power.  A flip moves one power term by one bf16 unit, at most 2^-7 of the
term, so a mel band moves by at most 2^-7 of itself whatever the number of
flips: max <= 10 log10(1 + 2^-7) = 0.0338 dB, reached by a band of one
frequency bin (1e-4 dB more for the f32 sums and the log); flips are rare,
so the 99th percentile stays <= 1e-3 dB.  Through the floor (1-Lipschitz) and the DCT
those bounds grow by at most max_c sum_m |dct[m, c]|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops import frontend as JF
from sept_tpu.ops.pallas_frontend import pallas_mel_spectrogram, pallas_mfcc
from sept_tpu_torch.ops import frontend as TF
from sept_tpu_torch.ops import mel as M
from sept_tpu_torch.ops.mfcc import floor_dct, floor_dct_plain, fused_mfcc

from _torch_helpers import BF16_GEOMETRY, expand_bf16_tables, speechlike

BF16_MAX, BF16_P99 = 10 * np.log10(1 + 2.0 ** -7) + 1e-4, 1e-3


@pytest.mark.parametrize("n_mfcc,n_mels,norm", [(40, 128, "ortho"), (13, 40, "ortho"),
                                                (20, 64, None)])
def test_create_dct_matches_jax(n_mfcc, n_mels, norm):
    ours = TF.create_dct(n_mfcc, n_mels, norm)
    assert ours.shape == (n_mels, n_mfcc) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, JF.create_dct(n_mfcc, n_mels, norm), rtol=0, atol=1e-7)


def test_create_dct_refuses_unknown_norm():
    with pytest.raises(ValueError, match="unsupported DCT norm"):
        TF.create_dct(40, 128, "slaney")


@pytest.mark.parametrize("spacing", [1.0, 2.0])
def test_np_gradient_matches_jax(rng, spacing):
    w = speechlike(rng, 5000)
    ours = TF.np_gradient(torch.from_numpy(w), spacing).numpy()
    np.testing.assert_allclose(ours, np.asarray(JF.np_gradient(jnp.asarray(w), spacing)),
                               atol=1e-6)
    np.testing.assert_allclose(ours, np.gradient(w, spacing), atol=1e-6)


@pytest.mark.parametrize("seconds", [0.3, 1.25])
def test_mfcc_matches_jax(rng, seconds):
    w = speechlike(rng, int(seconds * 16000))
    ours = TF.mfcc(torch.from_numpy(w)).numpy()
    theirs = np.asarray(JF.mfcc(jnp.asarray(w)))
    assert ours.shape == theirs.shape == (40, 1 + len(w) // 200)
    np.testing.assert_allclose(ours, theirs, atol=5e-3)


def test_mfcc_with_deltas_matches_jax(rng):
    w = speechlike(rng, 9000)
    ours = TF.mfcc_with_deltas(torch.from_numpy(w)).numpy()
    theirs = np.asarray(JF.mfcc_with_deltas(jnp.asarray(w)))
    assert ours.shape == theirs.shape == (120, 1 + 9000 // 200)
    np.testing.assert_allclose(ours, theirs, atol=5e-3)


def test_amplitude_to_db_floors_each_item_of_a_batch(rng):
    """A 4-D batch is floored item by item at its own max (JAX's
    ``amplitude_to_db`` over the trailing 3 axes), not at the loudest item's."""
    x = (10.0 ** rng.uniform(-12, 0, (3, 1, 16, 20))).astype(np.float32)
    x[1] *= 1e-6  # a quiet item: its own floor lies 60 dB under the batch's
    ours = TF.amplitude_to_db(torch.from_numpy(x), "power", 80.0).numpy()
    theirs = np.asarray(JF.amplitude_to_db(jnp.asarray(x), "power", 80.0))
    np.testing.assert_allclose(ours, theirs, atol=1e-4)
    for i in range(3):
        item = TF.amplitude_to_db(torch.from_numpy(x[i]), "power", 80.0).numpy()
        np.testing.assert_array_equal(ours[i], item)
    assert ours[1].min() < ours.max() - 80.0 - 1.0


def _padded(rng, lengths, n_fft):
    pad = n_fft // 2
    rows = [np.pad(speechlike(rng, n), (pad, pad), mode="reflect") for n in lengths]
    out = np.zeros((len(rows), max(len(r) for r in rows)), np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _bf16_close(ours, theirs):
    d = np.abs(ours - theirs)
    assert d.max() <= BF16_MAX, d.max()
    assert np.percentile(d, 99) <= BF16_P99, np.percentile(d, 99)


@pytest.mark.parametrize("n_fft,hop", [(800, 160), (400, 200)])
def test_mel_db_plain_bf16_matches_pallas_bf16(rng, n_fft, hop):
    padded = _padded(rng, (9000, 6000), n_fft)
    t = (padded.shape[1] - n_fft) // hop + 1
    ours = M.mel_db_plain(torch.from_numpy(padded), t, n_fft, hop, bf16=True).numpy()
    theirs = np.asarray(pallas_mel_spectrogram(jnp.asarray(padded), n_fft=n_fft, hop=hop,
                                               tile=32, bf16=True, interpret=True))
    assert ours.shape == (2, t, 128)
    _bf16_close(ours, theirs[:, :t])
    # the mode rounds: it is not the f32 chain
    f32 = M.mel_db_plain(torch.from_numpy(padded), t, n_fft, hop).numpy()
    assert np.abs(ours - f32).max() > 1e-3


def test_mel_db_bf16_takes_its_mode_on_the_cpu(rng):
    padded = torch.from_numpy(_padded(rng, (5000,), 800))
    t = (padded.shape[1] - 800) // 160 + 1
    want = M.mel_db_plain(padded, t, bf16=True)
    assert torch.equal(M.mel_db(padded, t, bf16=True), want)
    assert torch.equal(M.mel_db_bf16(padded, t), want)
    pcm = (padded * 20000).to(torch.int16)
    assert torch.equal(M.mel_db_bf16(pcm, t), M.mel_db_bf16(pcm.float() / 32768.0, t))
    with pytest.raises(ValueError, match="no kernel for meta"):
        M.mel_db_bf16(torch.empty((1, 2000), device="meta"), 5)


@pytest.mark.parametrize("n_fft,n_mels", [(800, 128), (400, 128), (1600, 40), (800, 40),
                                          (800, 256), (799, 80), (2048, 256), (1600, 256),
                                          (2, 1), (800, 320), (2048, 512), (1024, 384)])
def test_bf16_kernel_tables_hold_the_plain_tables(n_fft, n_mels):
    """The kernel's swizzled cos/sin tiles (cos and sin of a frequency
    interleaved; chunks cut to a multiple of 16 frequencies) and filterbank
    tiles (a mel row over a chunk's frequencies, passes of 128 mels) carry
    exactly the plain version's bf16 tables, zeros elsewhere, and each mask
    bit marks a nonzero sub-tile."""
    window, cos_k, sin_k, fb_k = expand_bf16_tables(n_fft, n_mels)
    w_p, cos_p, sin_p, fb_p = M._tables_bf16(n_fft, n_mels, torch.device("cpu"))
    n_freq = n_fft // 2 + 1
    assert torch.equal(window, w_p)
    assert torch.equal(cos_k[:n_fft, :n_freq], cos_p.float())
    assert torch.equal(sin_k[:n_fft, :n_freq], sin_p.float())
    for t in (cos_k, sin_k):
        assert not t[n_fft:].any() and not t[:, n_freq:].any()
    assert torch.equal(fb_k[:n_freq, :n_mels], fb_p.float())
    assert not fb_k[n_freq:].any() and not fb_k[:, n_mels:].any()
    widths = M.bf16_chunks(n_fft, BF16_GEOMETRY)
    assert sum(widths) - n_freq < 16 and all(w % 16 == 0 for w in widths)


def test_floor_dct_plain_matches_jax_floor_dot(rng):
    mel = rng.uniform(-100.0, 40.0, (300, 128)).astype(np.float32)
    floor = rng.uniform(-60.0, 0.0, 300).astype(np.float32)
    dct = JF.create_dct(40, 128, "ortho")
    want = np.asarray(jnp.dot(jnp.maximum(jnp.asarray(mel), jnp.asarray(floor)[:, None]),
                              jnp.asarray(dct), precision=JF.PARITY_PRECISION))
    ours = floor_dct(torch.from_numpy(mel), torch.from_numpy(floor),
                     torch.tensor(TF.create_dct(40, 128))).numpy()
    # two f32 sums of 128 terms in different orders: 1e-6 of the largest
    # coefficient (~200 here) apart at most
    np.testing.assert_allclose(ours, want, rtol=0, atol=1e-6 * np.abs(want).max())
    plain = floor_dct_plain(torch.from_numpy(mel), torch.from_numpy(floor),
                            torch.from_numpy(dct)).numpy()
    np.testing.assert_array_equal(ours, plain)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_mfcc_matches_pallas_mfcc(rng, bf16):
    """End to end, the two MFCCs differ by their mels' difference passed
    through the floor and the DCT: within gain * max |mel - JAX mel|, the mels
    themselves within the bounds of ``test_mel_db_plain_matches_pallas_interpret``
    (f32, 2e-2 dB) and of the bf16 mode above."""
    padded = _padded(rng, (12000, 7000), 400)
    t = (padded.shape[1] - 400) // 200 + 1
    ours = fused_mfcc(padded, t, bf16=bf16, device="cpu").numpy()
    theirs = np.asarray(pallas_mfcc(jnp.asarray(padded), tile=32, bf16=bf16,
                                    interpret=True))
    assert ours.shape == theirs.shape == (2, t, 40)
    mel = M.mel_db_plain(torch.from_numpy(padded), t, 400, 200, bf16=bf16).numpy()
    jmel = np.asarray(pallas_mel_spectrogram(jnp.asarray(padded), n_fft=400, hop=200,
                                             tile=32, bf16=bf16, interpret=True))[:, :t]
    dmel = np.abs(mel - jmel)
    if bf16:
        _bf16_close(mel, jmel)
    else:
        assert dmel.max() <= 2e-2
    gain = float(np.abs(TF.create_dct(40, 128)).sum(0).max())
    d = np.abs(ours - theirs)
    assert d.max() <= gain * dmel.max() + 1e-4, (d.max(), dmel.max())
    if bf16:
        assert np.percentile(d, 99) <= gain * BF16_P99, np.percentile(d, 99)


def test_floor_dct_stage_matches_pallas_mfcc(rng):
    """On the same mel (JAX's), the port's per-utterance floor and floor + DCT
    equal ``pallas_mfcc``'s within the JAX test's own bound, 1e-4."""
    padded = _padded(rng, (12000, 7000), 400)
    t = (padded.shape[1] - 400) // 200 + 1
    jmel = np.asarray(pallas_mel_spectrogram(jnp.asarray(padded), n_fft=400, hop=200,
                                             tile=32, interpret=True))[:, :t]
    floor = np.repeat(jmel.max(axis=(1, 2)) - 80.0, t)
    ours = floor_dct(torch.from_numpy(jmel.reshape(-1, 128)), torch.from_numpy(floor),
                     torch.tensor(TF.create_dct(40, 128))).numpy()
    theirs = np.asarray(pallas_mfcc(jnp.asarray(padded), tile=32, interpret=True))
    np.testing.assert_allclose(ours.reshape(2, t, 40), theirs, atol=1e-4)


def test_fused_mfcc_without_top_db_is_the_plain_dct(rng):
    padded = _padded(rng, (6000,), 400)
    t = (padded.shape[1] - 400) // 200 + 1
    ours = fused_mfcc(padded, t, top_db=None, device="cpu").numpy()
    mel = M.mel_db_plain(torch.from_numpy(padded), t, 400, 200)
    np.testing.assert_array_equal(ours, (mel @ torch.tensor(TF.create_dct(40, 128))).numpy())
    theirs = np.asarray(pallas_mfcc(jnp.asarray(padded), tile=32, top_db=None,
                                    interpret=True))
    jmel = np.asarray(pallas_mel_spectrogram(jnp.asarray(padded), n_fft=400, hop=200,
                                             tile=32, interpret=True))[:, :t]
    gain = float(np.abs(TF.create_dct(40, 128)).sum(0).max())
    dmel = np.abs(mel.numpy() - jmel).max()
    assert np.abs(ours - theirs).max() <= gain * dmel + 1e-4


def test_floor_dct_refuses_devices_without_a_kernel():
    x = torch.empty((4, 128), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        floor_dct(x, torch.empty(4, device="meta"), torch.empty((128, 40), device="meta"))
