"""The f32 mel kernel's FFT plan and sparse mel bank (``ops/mel.py``), and a
CPU restatement of what the kernel does with them, vs the plain version and
the JAX package's Pallas kernel (CPU).

The CUDA kernel runs only on the card.  What it computes is restated here in
torch, step for step: the windowed frame packed as z[n] = x[2n] + i x[2n+1]
in float64, the plan's Stockham passes (input i + r*M/R of a radix-R pass
over p combined points, twiddled by the plan's exp(-2 pi i r (i%p) / (p R)),
goes through a length-R DFT to output (i - i%p)*R + i%p + s*p; where M has a
prime factor above 5, Bluestein's convolution over the plan's chirp and
filter tables) and the split post-pass for bins
0..n_fft/2 in float64 (for an odd n_fft: frames 2j and 2j + 1 as the real
and imaginary parts of one complex FFT of n_fft, split after it),
then X rounded to f32, the f32 power, and each band's bins summed in
ascending order from the sparse bank.

The bound is 1e-3 dB, the kernel's tolerance against its plain version, on
``speechlike`` signals, held cell by cell as ``chip_smoke.py`` holds the
kernel: within 1e-3 dB of the plain version (and of JAX's kernel), or, where
the two part by more, no farther from the float64 truth (numpy's float64
rfft of the same windowed frames through the same bank) than the reference
is, plus 1e-3 dB.  Readings on this file's inputs (seed 8): the plain
version is up to 9.9e-4 dB off the truth, JAX's kernel 8.0e-4, the
restatement 3.8e-6, so the restatement parts from neither by more than
1e-3; it is also held to the truth at 1e-3 dB everywhere, and at 1e-4 dB on
the gradient streams the mfcc feeds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops.pallas_frontend import pallas_mel_spectrogram
from sept_tpu_torch.ops import frontend as TF
from sept_tpu_torch.ops import mel as M

from _torch_helpers import speechlike

SHAPES = [(400, 200), (800, 160), (1600, 160)]  # mfcc; serving, ingest, mel1; mel2


def _padded(rng, lengths, n_fft):
    pad = n_fft // 2
    rows = [np.pad(speechlike(rng, n), (pad, pad), mode="reflect") for n in lengths]
    out = np.zeros((len(rows), max(len(r) for r in rows)), np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def _truth(padded, t, n_fft, hop, n_mels=128):
    """The function in float64: the f32 samples and window widened, numpy's
    rfft, the power, the f32 bank widened, the log."""
    idx = np.arange(t)[:, None] * hop + np.arange(n_fft)
    frames = padded.astype(np.float64)[:, idx] * TF.hann_window(n_fft).astype(np.float64)
    power = np.abs(np.fft.rfft(frames)) ** 2
    fb = TF.melscale_fbanks(n_fft // 2 + 1, 0.0, 8000.0, n_mels, 16000).astype(np.float64)
    return 10.0 * np.log10(np.maximum(power @ fb, M.AMIN))


def assert_within(ours, ref, truth, tol=1e-3):
    """``ours`` within ``tol`` dB of ``ref`` on every cell, or, where the two
    part by more, no farther from the float64 ``truth`` than ``ref`` is,
    plus ``tol``."""
    part = np.abs(ours - ref) > tol
    e, r = np.abs(ours - truth)[part], np.abs(ref - truth)[part]
    assert (e <= r + tol).all(), (e, r)


def _smooth(n):
    """n has no prime factor above 5."""
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def _stockham(z, radices, tw):
    """The plan's passes over the last axis of ``z`` (complex), as the
    kernel's fft_pass runs them; returns (Z, table entries used)."""
    m = z.shape[-1]
    p, off = 1, 0
    for r in radices:
        nb = m // r
        i = torch.arange(nb)
        k = i % p
        u = torch.stack([z[..., i + q * nb] for q in range(r)])  # (R, ..., nb)
        t = tw[off:off + p * (r - 1)].reshape(p, r - 1)[k].T
        u = torch.cat([u[:1], u[1:] * t.reshape((r - 1,) + (1,) * (z.dim() - 1) + (nb,))])
        s = torch.arange(r)
        omega = torch.exp(-2j * torch.pi * torch.outer(s, s).to(torch.float64) / r).to(z.dtype)
        v = torch.einsum("sr,r...->s...", omega, u)
        out = torch.empty_like(z)
        j = (i - k) * r + k
        for q in range(r):
            out[..., j + q * p] = v[q]
        z, off, p = out, off + p * (r - 1), p * r
    return z, off


def _fft_m(z, n_fft, radices, tw):
    """The kernel's complex DFT of length M over the last axis of ``z``: the
    plan's passes, or Bluestein's convolution where the plan's length F is
    not M (z times the chirp, zero-padded to F; the passes; times the
    filter's spectrum; the passes again on the conjugate; the conjugate
    times the chirp).  Returns (Z, offset of the post-pass twiddles)."""
    m = z.shape[-1]
    f = M.bluestein_length(n_fft)
    if not f:
        return _stockham(z, radices, tw)
    chirp, filt = tw[len(tw) - f - m:len(tw) - f], tw[len(tw) - f:]
    a = torch.zeros(z.shape[:-1] + (f,), dtype=z.dtype)
    a[..., :m] = z * chirp
    a, off = _stockham(a, radices, tw)
    c, _ = _stockham((a * filt).conj(), radices, tw)
    return chirp * c[..., :m].conj(), off


def mel_fft_restated(padded, t, n_fft, hop, n_mels=128, dtype=torch.float32):
    """The f32 kernel's function on the CPU: the windowed frame (exact in
    float64), the FFT and, for an even n_fft, the post-pass in float64, then
    ``dtype`` for X, the power and the bank (float32: as the kernel rounds
    them, up to summation order; float64: the function unrounded)."""
    radices, tw = M.fft_plan(n_fft)
    tw = torch.from_numpy(tw)
    index, weights = M.sparse_bank(n_fft, n_mels)
    window = torch.tensor(TF.hann_window(n_fft)).double()
    frames = torch.from_numpy(padded).double().unfold(1, n_fft, hop)[:, :t] * window
    cd = torch.complex64 if dtype == torch.float32 else torch.complex128
    m = n_fft // 2
    power = torch.empty(frames.shape[:-1] + (m + 1,), dtype=dtype)
    if n_fft % 2:  # frames 2j and 2j + 1 as one complex FFT of n_fft, then split
        pairs = torch.nn.functional.pad(frames, (0, 0, 0, frames.shape[1] % 2))
        z = torch.complex(pairs[:, 0::2], pairs[:, 1::2])
        zk, _ = _fft_m(z, n_fft, radices, tw)
        k = torch.arange(m + 1)
        zc = zk[..., (n_fft - k) % n_fft].conj()
        x = torch.stack([(zk[..., k] + zc) * 0.5, -0.5j * (zk[..., k] - zc)], 2)
        x = x.flatten(1, 2)[:, :frames.shape[1]].to(cd)  # frames back in order
        power[:] = x.real * x.real + x.imag * x.imag
    else:
        z = torch.complex(frames[..., 0::2], frames[..., 1::2])
        zk, off = _fft_m(z, n_fft, radices, tw)
        k = torch.arange(m // 2 + 1)
        zc = zk[..., (m - k) % m].conj()
        e = (zk[..., k] + zc) * 0.5
        o = -1j * (zk[..., k] - zc) * 0.5
        wo = tw[off:off + m // 2 + 1] * o
        x1, x2 = (e + wo).to(cd), (e - wo).to(cd)  # X[k], conj(X[m - k])
        power[..., m - k] = x2.real * x2.real + x2.imag * x2.imag
        power[..., k] = x1.real * x1.real + x1.imag * x1.imag
    mel = torch.zeros(frames.shape[:-1] + (n_mels,), dtype=dtype)
    w = torch.from_numpy(weights).to(dtype)
    for band in range(n_mels):
        first, count, offset = (int(v) for v in index[:, band])
        for q in range(count):  # ascending bins, as the kernel sums them
            mel[..., band] += power[..., first + q] * w[offset + q]
    return 10.0 * torch.log10(torch.clamp(mel, min=M.AMIN))


@pytest.mark.parametrize("n_fft", [400, 800, 1600])
def test_fft_plan_factors_half_of_n_fft(n_fft):
    radices, tw = M.fft_plan(n_fft)
    assert int(np.prod(radices)) == n_fft // 2
    assert set(radices) <= {2, 3, 4, 5}
    assert list(radices) == sorted(radices, key=(4, 2, 5, 3).index)
    p, n_pass = 1, 0
    for r in radices:
        n_pass += p * (r - 1)
        p *= r
    assert tw.shape == (n_pass + n_fft // 4 + 1,) and tw.dtype == np.complex128
    np.testing.assert_allclose(np.abs(tw), 1.0, atol=1e-15)


@pytest.mark.parametrize("n_fft", [0, 1])
def test_fft_radices_refuse_n_fft_outside_the_rule(n_fft):
    with pytest.raises(ValueError, match="n_fft must be >= 2"):
        M.fft_radices(n_fft)


# n_fft off the 2-3-5 rule, each through Bluestein: prime halves 802 and
# 2042, 402 = 2 * 3 * 67, 1022 = 2 * 7 * 73, 14 and 858 = 2 * 3 * 11 * 13,
# odd 7, 799 = 17 * 47, 1001 = 7 * 11 * 13 and 2047 = 23 * 89 (the largest
# buffers); and 2048 (radix 4 only, 4 warps a block)
@pytest.mark.parametrize("n_fft", [802, 402, 14, 7, 799, 1022, 2042, 2048, 858, 1001, 2047])
def test_any_n_fft_plans_and_restates(rng, n_fft):
    hop = 160
    radices, tw = M.fft_plan(n_fft)
    m, f = M.fft_length(n_fft), M.bluestein_length(n_fft)
    assert m == (n_fft if n_fft % 2 else n_fft // 2)
    assert bool(f) == (n_fft != 2048)  # M off the 2-3-5 rule: Bluestein's smooth length
    if f:
        assert 2 * m - 1 <= f < 4 * m
        assert _smooth(f) and not any(_smooth(n) for n in range(2 * m - 1, f))  # the least
    assert int(np.prod(radices)) == (f or m)
    assert set(radices) <= {2, 3, 4, 5}
    assert list(radices) == sorted(radices, key=(4, 2, 5, 3).index)
    padded = _padded(rng, (3000,), n_fft)
    t = (padded.shape[1] - n_fft) // hop + 1
    frames = (padded.astype(np.float64)[0, np.arange(t)[:, None] * hop + np.arange(n_fft)]
              * TF.hann_window(n_fft).astype(np.float64))
    z = frames + 0j if n_fft % 2 else frames[:, 0::2] + 1j * frames[:, 1::2]
    zk, used = _fft_m(torch.from_numpy(z), n_fft, radices, torch.from_numpy(tw))
    assert used + (0 if n_fft % 2 else n_fft // 4 + 1) + (m + f if f else 0) == len(tw)
    np.testing.assert_allclose(zk.numpy(), np.fft.fft(z), atol=1e-9)
    dense = TF.melscale_fbanks(n_fft // 2 + 1, 0.0, 8000.0, 128, 16000).astype(np.float64)
    want = 10 * np.log10(np.maximum((np.abs(np.fft.rfft(frames)) ** 2) @ dense, M.AMIN))
    ours = mel_fft_restated(padded, t, n_fft, hop, dtype=torch.float64).numpy()[0]
    np.testing.assert_allclose(ours, want, atol=1e-9)
    ours = mel_fft_restated(padded, t, n_fft, hop).numpy()
    np.testing.assert_allclose(ours, _truth(padded, t, n_fft, hop), atol=1e-4, rtol=0)


@pytest.mark.parametrize("n_fft,n_mels", [(400, 128), (800, 128), (1600, 128), (800, 40)])
def test_sparse_bank_expands_to_the_dense_bank(n_fft, n_mels):
    index, weights = M.sparse_bank(n_fft, n_mels)
    dense = TF.melscale_fbanks(n_fft // 2 + 1, 0.0, 8000.0, n_mels, 16000)
    assert index.shape == (3, n_mels) and index.dtype == np.int32
    assert weights.dtype == np.float32 and len(weights) == index[1].sum()
    back = np.zeros_like(dense)
    for m in range(n_mels):
        first, count, offset = index[:, m]
        back[first:first + count, m] = weights[offset:offset + count]
    assert np.array_equal(back, dense)
    assert (np.diff(index[2]) == index[1][:-1]).all()  # bands one after another


@pytest.mark.parametrize("n_fft,hop", SHAPES + [(802, 160)])
def test_restated_kernel_matches_plain_and_pallas(rng, n_fft, hop):
    padded = _padded(rng, (7000, 4100), n_fft)
    t = (padded.shape[1] - n_fft) // hop + 1 - 3  # not a multiple of the block's frames
    plain = M.mel_db_plain(torch.from_numpy(padded), t, n_fft, hop).numpy()
    theirs = np.asarray(pallas_mel_spectrogram(jnp.asarray(padded), n_fft=n_fft, hop=hop,
                                               tile=32, interpret=True))[:, :t]
    ours = mel_fft_restated(padded, t, n_fft, hop).numpy()
    truth = _truth(padded, t, n_fft, hop)
    assert ours.shape == plain.shape == (2, t, 128)
    np.testing.assert_allclose(ours, truth, atol=1e-3, rtol=0)
    assert_within(ours, plain, truth)
    assert_within(ours, theirs, truth)


@pytest.mark.parametrize("n_fft,hop", SHAPES)
def test_restated_kernel_in_float64_is_the_function(rng, n_fft, hop):
    padded = _padded(rng, (5000,), n_fft)
    t = (padded.shape[1] - n_fft) // hop + 1
    ours = mel_fft_restated(padded, t, n_fft, hop, dtype=torch.float64).numpy()
    np.testing.assert_allclose(ours, _truth(padded, t, n_fft, hop), atol=1e-9, rtol=0)


@pytest.mark.parametrize("n_fft,hop", SHAPES)
def test_restated_kernel_holds_the_truth_on_gradient_streams(rng, n_fft, hop):
    """The mfcc's streams (the wave and its np.gradient at spacings 1 and 2)
    hold bands 60-130 dB under their frame's peak, where an FFT in f32 parts
    from the truth by up to 1e-2 dB: the kernel's float64 FFT keeps every
    cell within 1e-4 dB of the truth (5e-6 at most on these inputs)."""
    wave = speechlike(rng, 6000)
    rows = [np.pad(s, (n_fft // 2,) * 2, mode="reflect").astype(np.float32)
            for s in (wave, np.gradient(wave, 1.0), np.gradient(wave, 2.0))]
    padded = np.stack(rows)
    t = (padded.shape[1] - n_fft) // hop + 1
    truth = _truth(padded, t, n_fft, hop)
    ours = mel_fft_restated(padded, t, n_fft, hop).numpy()
    np.testing.assert_allclose(ours, truth, atol=1e-4, rtol=0)


def test_restated_post_pass_gives_the_real_dft_power(rng):
    """Bins 0 and n_fft/2 (the post-pass's conjugate indexing) included: the
    float64 restatement's power equals numpy's rfft power of the windowed
    frame, on an n_fft whose plan has all four radices (2 * 4 * 3 * 5)."""
    n_fft, hop = 240, 60
    padded = _padded(rng, (1200,), n_fft)
    t = (padded.shape[1] - n_fft) // hop + 1
    radices, tw = M.fft_plan(n_fft)
    assert set(radices) == {2, 3, 4, 5}
    frames = (padded.astype(np.float64)[0, np.arange(t)[:, None] * hop + np.arange(n_fft)]
              * TF.hann_window(n_fft).astype(np.float64))
    frames = torch.from_numpy(frames)
    z = torch.complex(frames[..., 0::2], frames[..., 1::2])
    zk, _ = _stockham(z, radices, torch.from_numpy(tw))
    np.testing.assert_allclose(zk.numpy(), np.fft.fft(z.numpy()), atol=1e-9)
    want = np.abs(np.fft.rfft(frames.numpy())) ** 2
    ours = mel_fft_restated(padded, t, n_fft, hop, dtype=torch.float64)
    dense = TF.melscale_fbanks(n_fft // 2 + 1, 0.0, 8000.0, 128, 16000).astype(np.float64)
    ref = 10 * np.log10(np.maximum(want @ dense, M.AMIN))
    np.testing.assert_allclose(ours.numpy()[0], ref, atol=1e-9)


def test_mel_db_refuses_n_fft_outside_the_rule_before_a_launch():
    """A tensor off the CPU meets the n_fft rule before anything else of the
    kernel's path: n_fft 802 passes it and reaches the device check (a meta
    tensor has no kernel), n_fft 0 does not; the CPU plain version takes any
    n_fft."""
    launches = M.mel_db.launches
    x = torch.empty((2, 3000), device="meta")
    with pytest.raises(ValueError, match="no kernel for meta"):
        M.mel_db(x, 5, n_fft=802)
    with pytest.raises(ValueError, match="n_fft must be >= 2"):
        M.mel_db(x, 5, n_fft=0)
    assert M.mel_db.launches == launches
    cpu = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 3000)).astype(np.float32))
    assert M.mel_db(cpu, 5, n_fft=802).shape == (1, 5, 128)
