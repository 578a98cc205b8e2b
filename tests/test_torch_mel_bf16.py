"""The bf16 mel kernel's tables (``ops/mel.py::_kernel_tables_bf16``; their
expansion back to the plain tables is held in ``tests/test_torch_mfcc.py``)
and a CPU restatement of what the kernel does with them, vs the plain version and
the JAX package's bf16 Pallas kernel in interpret mode (CPU).

The CUDA kernel (``csrc/mel.cu``, ``bfk::mel_bf16_kernel``) runs only on the
card; ``chip_smoke.py`` holds it against the plain version there.  What it
computes is restated here in torch, tile for tile: the windowed frame tile
rounded at points 1-3; per chunk of 64 frequencies (the last cut to a
multiple of 16) the DFT product over 64-tap slabs of the swizzled cos/sin
tiles (cos and sin of a frequency in adjacent columns), accumulated in f32;
the f32 power of each (re, im) pair rounded to bf16 into the chunk's power
tile; the chunk's share of the mel product against its filterbank tile,
64 mel columns a warpgroup, over the chunk's frequencies in k-steps of 16,
only over the 32-mel sub-tiles its mask marks, summed over the chunks in
f32 per pass of 128 mels; then 10*log10(max(., 1e-10)).

Bounds (``tests/test_torch_mfcc.py``'s): the restatement and the plain
version round the same operands at the same six places and differ in f32
summation order, which can flip a bf16 rounding of a power term: max <=
10 log10(1 + 2^-7) + 1e-4 dB, p99 <= 1e-3 dB; the same against JAX's
kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops.pallas_frontend import pallas_mel_spectrogram
from sept_tpu_torch.ops import mel as M

from _torch_helpers import BF16_GEOMETRY, bf16_kernel_tables, speechlike

BF16_MAX, BF16_P99 = 10 * np.log10(1 + 2.0 ** -7) + 1e-4, 1e-3
BF = torch.bfloat16


def _padded(rng, lengths, n_fft):
    pad = n_fft // 2
    rows = [np.pad(speechlike(rng, n), (pad, pad), mode="reflect") for n in lengths]
    out = np.zeros((len(rows), max(len(r) for r in rows)), np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def restated(padded, t, n_fft, hop, n_mels):
    """The bf16 kernel's function, computed from its own tables in its own
    tile order (see the module docstring).  padded: (B, L) f32 numpy."""
    nc, ks, mel_tile, mel_sub, _ = BF16_GEOMETRY
    window, table, bank, masks = bf16_kernel_tables(n_fft, n_mels)
    widths = M.bf16_chunks(n_fft, BF16_GEOMETRY)
    k_pad = -(-n_fft // ks) * ks
    x = torch.from_numpy(padded).to(BF).float()                       # point 1
    frames = x.unfold(1, n_fft, hop)[:, :t]                           # (B, T, n_fft)
    a = (frames * window.float()).to(BF).float()                      # points 2-3
    a = torch.nn.functional.pad(a, (0, k_pad - n_fft))
    passes = -(-n_mels // mel_tile)
    out = []
    for p in range(passes):
        mel = torch.zeros(a.shape[:2] + (mel_tile,))
        for c, w in enumerate(widths):
            base = c * nc * k_pad * 2                                 # earlier chunks are whole
            acc = torch.zeros(a.shape[:2] + (2 * w,))
            for k in range(0, k_pad, ks):
                off = base + k * 2 * w
                tile = M.swizzle_tile(table[off:off + 2 * w * ks].view(2 * w, ks)).float()
                acc += a[..., k:k + ks] @ tile.T                       # f32 sums
            re, im = acc[..., 0::2], acc[..., 1::2]
            power = (re * re + im * im).to(BF).float()                # point 5
            off = (p * len(widths) + c) * mel_tile * ks
            blk = M.swizzle_tile(bank[off:off + mel_tile * ks].view(mel_tile, ks)).float()
            for sub in range(mel_tile // mel_sub):
                if int(masks[p, c]) >> sub & 1:
                    cols = slice(sub * mel_sub, (sub + 1) * mel_sub)
                    for f in range(0, w, 16):                         # wgmma k-steps
                        mel[..., cols] += power[..., f:f + 16] @ blk[cols, f:f + 16].T
        out.append(mel)
    mel = torch.cat(out, -1)[..., :n_mels]
    return (10.0 * torch.log10(torch.clamp(mel, min=M.AMIN))).numpy()


def _bf16_close(ours, theirs):
    d = np.abs(ours - theirs)
    assert d.max() <= BF16_MAX, d.max()
    assert np.percentile(d, 99) <= BF16_P99, np.percentile(d, 99)


def test_zero_bank_sub_tiles_are_skipped():
    """At the ingest's shape the filterbank is zero in most (chunk, 32-mel)
    sub-tiles: the kernel neither copies nor multiplies those."""
    masks = bf16_kernel_tables(800, 128)[3]
    bits = sum(bin(int(m)).count("1") for m in masks.flatten())
    assert 0 < bits < masks.numel() * 4


@pytest.mark.parametrize("n_fft,hop,n_mels", [(800, 160, 128), (400, 200, 128),
                                              (799, 160, 80), (1600, 160, 40), (800, 320, 128)])
def test_restated_kernel_matches_plain_and_pallas(rng, n_fft, hop, n_mels):
    padded = _padded(rng, (9000, 6000), n_fft)
    t = (padded.shape[1] - n_fft) // hop + 1
    ours = restated(padded, t, n_fft, hop, n_mels)
    plain = M.mel_db_plain(torch.from_numpy(padded), t, n_fft, hop, n_mels, bf16=True).numpy()
    assert ours.shape == plain.shape == (2, t, n_mels)
    _bf16_close(ours, plain)
    theirs = np.asarray(pallas_mel_spectrogram(jnp.asarray(padded), n_fft=n_fft, hop=hop,
                                               n_mels=n_mels, tile=32, bf16=True,
                                               interpret=True))
    _bf16_close(ours, theirs[:, :t])


@pytest.mark.parametrize("n_mels", [256, 160])
def test_restated_kernel_takes_two_mel_passes(rng, n_mels):
    """n_mels above 128 runs the chunks once a pass of 128 mels (the fault
    closed: the kernel refused n_mels > 128)."""
    padded = _padded(rng, (7000,), 800)
    t = (padded.shape[1] - 800) // 160 + 1
    ours = restated(padded, t, 800, 160, n_mels)
    plain = M.mel_db_plain(torch.from_numpy(padded), t, 800, 160, n_mels, bf16=True).numpy()
    assert ours.shape == (1, t, n_mels)
    _bf16_close(ours, plain)
    assert (ours[..., 128:] > -100).any()  # the second pass carries the bands


@pytest.mark.parametrize("n_fft,n_mels", [(800, 320), (2048, 512)])
def test_restated_kernel_takes_three_and_four_mel_passes(rng, n_fft, n_mels):
    """Past 256 mels (the cap lifted: the kernel refused n_mels > 256) the
    chunks run once a pass of 128 mels, as many passes as the bank needs;
    bands with no frequency bin are -100 dB on every side."""
    padded = _padded(rng, (7000,), n_fft)
    t = (padded.shape[1] - n_fft) // 160 + 1
    ours = restated(padded, t, n_fft, 160, n_mels)
    plain = M.mel_db_plain(torch.from_numpy(padded), t, n_fft, 160, n_mels, bf16=True).numpy()
    assert ours.shape == (1, t, n_mels)
    _bf16_close(ours, plain)
    theirs = np.asarray(pallas_mel_spectrogram(jnp.asarray(padded), n_fft=n_fft, hop=160,
                                               n_mels=n_mels, tile=32, bf16=True,
                                               interpret=True))
    _bf16_close(ours, theirs[:, :t])
    assert (ours[..., 256:] > -100).any()  # the later passes carry bands
    masks = bf16_kernel_tables(n_fft, n_mels)[3]
    assert masks.shape[0] == -(-n_mels // 128)
