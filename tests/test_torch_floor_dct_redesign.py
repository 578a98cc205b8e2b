"""The floor + DCT kernel as its redesign computes it, restated on the CPU,
vs the port's plain version and the JAX package's ``pallas_mfcc`` (interpret
mode); and the mel plain version at the widths the kernels now take (n_mels
320 and 512) vs JAX's ``pallas_mel_spectrogram`` (interpret mode).

The CUDA kernel (``csrc/mfcc.cu``, ``floor_dct_kernel``) runs only on the
card; ``chip_smoke.py`` holds it against the plain version there.  What it
computes is restated here with its geometry: persistent blocks (two an SM
where two stages and the basis fit in half of its shared memory, else one;
gridDim.x of them a coefficient tile, at most one a row tile) walking row
tiles of 256 rows, block k taking tiles k, k + gridDim.x, ...; coefficient
tiles of 40 (gridDim.y); the mels in chunks of 32 (zeros past the last row
and mel, as the tensor copy fills them), a chunk's rows in the copy's
128-byte swizzle; the basis tile laid out a mel at a time as 4 groups of 10
coefficients padded to 12; where the basis does not fit beside the ring,
launches of ``kr`` mels, each continuing the sums from the output.  Each
output is sum_m max(mel, floor) * dct in ascending m, one rounding to f32 a
step (the kernel's FMA; here the product is exact in float64 and the sum
rounded once to float64 and once to f32).

Tolerance: 1e-5 of max |plain| (``chip_smoke.py``'s ``FLOOR_DCT_RTOL``): the
plain version's matmul sums the same terms in another order.  Against JAX,
the same bound of max |JAX| on JAX's own mel; the mel plain version within
2e-2 dB of JAX's f32 kernel (``tests/test_torch_frontend.py``'s bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sept_tpu.ops.pallas_frontend import pallas_mel_spectrogram, pallas_mfcc
from sept_tpu_torch.ops import frontend as TF
from sept_tpu_torch.ops import mel as M
from sept_tpu_torch.ops.mfcc import floor_dct, floor_dct_plain

from _torch_helpers import speechlike

RTOL = 1e-5
# the kernel's geometry (csrc/mfcc.cu): rows a tile, mels a chunk, lane
# groups, coefficients a lane (a group), padded, ring stages at most, the
# shared memory a block may take, and each of two blocks on an SM
TILE_ROWS, KT, GROUPS, CPL, CPAD, MAX_STAGES = 256, 32, 4, 10, 12, 3
SMEM_LIMIT, SMEM_HALF = 232448, 115712
CT = GROUPS * CPL
STAGE_BYTES = TILE_ROWS * KT * 4
FIXED = 1024 + 2 * MAX_STAGES * 8
SMS = 3  # a small persistent grid, so that blocks walk several row tiles


def layout(n_mels):
    """(stages, mels a launch, shared bytes, blocks an SM) as ``Layout`` in
    mfcc.cu."""
    k_pad = -(-n_mels // KT) * KT
    whole = k_pad * GROUPS * CPAD * 4
    limit = SMEM_HALF if 2 * STAGE_BYTES + whole + FIXED <= SMEM_HALF else SMEM_LIMIT
    stages = MAX_STAGES
    while stages > 2 and stages * STAGE_BYTES + whole + FIXED > limit:
        stages -= 1
    fit = (limit - FIXED - stages * STAGE_BYTES) // (GROUPS * CPAD * 4) // KT * KT
    kr = min(k_pad, fit)
    total = stages * STAGE_BYTES + kr * GROUPS * CPAD * 4 + 2 * MAX_STAGES * 8 + 1024
    return stages, kr, total, 2 if limit == SMEM_HALF else 1


def swz(row):
    """The 128-byte swizzle: word w of a chunk's row is stored at w ^ swz(row)."""
    return row & 7


def floor_dct_restated(mel, floor, dct, sms=SMS):
    """out[r, c] = sum_m max(mel[r, m], floor[r]) dct[m, c] (float32 numpy)
    as the kernel's launches, blocks, tiles and chunks compute it; asserts
    that each launch writes every output once."""
    rows, n_mels = mel.shape
    n_mfcc = dct.shape[1]
    _, kr, _, per_sm = layout(n_mels)
    n_ct, n_tiles = -(-n_mfcc // CT), -(-rows // TILE_ROWS)
    gx = max(1, min(n_tiles, max(1, sms * per_sm // n_ct)))
    out = np.zeros((rows, n_mfcc), np.float32)
    for k0 in range(0, n_mels, kr):
        k_end = min(n_mels, k0 + kr)
        n_chunks = -(-(k_end - k0) // KT)
        written = np.zeros((rows, n_mfcc), np.int64)
        for by in range(n_ct):
            c0 = by * CT
            ct = min(CT, n_mfcc - c0)
            basis = np.zeros((n_chunks * KT, GROUPS, CPAD), np.float32)
            for g in range(GROUPS):
                cols = np.arange(c0 + g * CPL, min(c0 + (g + 1) * CPL, n_mfcc))
                basis[:k_end - k0, g, :len(cols)] = dct[k0:k_end][:, cols]
            for bx in range(gx):
                for tile in range(bx, n_tiles, gx):
                    r = tile * TILE_ROWS + np.arange(TILE_ROWS)
                    valid = r < rows
                    rv = r[valid]
                    acc = np.zeros((TILE_ROWS, GROUPS, CPL), np.float32)
                    if k0 > 0:  # a later launch continues the sums from the output
                        acc.reshape(TILE_ROWS, CT)[valid, :ct] = out[rv, c0:c0 + ct]
                    fl = np.zeros(TILE_ROWS, np.float32)
                    fl[valid] = floor[rv]
                    for q in range(n_chunks):
                        kc = k0 + q * KT
                        chunk = np.zeros((TILE_ROWS, KT), np.float32)   # the copy's zero fill
                        ks = np.arange(kc, min(kc + KT, n_mels))
                        chunk[np.ix_(np.flatnonzero(valid), ks - kc)] = mel[np.ix_(rv, ks)]
                        # through the stage's swizzled layout and back
                        words = chunk.reshape(TILE_ROWS, KT // 4, 4)
                        stage = np.empty_like(words)
                        line = np.arange(TILE_ROWS)
                        for w in range(KT // 4):
                            stage[line, w ^ swz(line)] = words[:, w]
                        x = np.stack([stage[line, w ^ swz(line)] for w in range(KT // 4)],
                                     1).reshape(TILE_ROWS, KT)
                        x = np.maximum(x, fl[:, None])
                        for k in range(KT):   # ascending mels, one rounding a step
                            b = basis[q * KT + k, :, :CPL]
                            acc = (acc.astype(np.float64) + x[:, k, None, None].astype(np.float64)
                                   * b[None].astype(np.float64)).astype(np.float32)
                    flat = acc.reshape(TILE_ROWS, CT)
                    out[rv, c0:c0 + ct] = flat[valid, :ct]
                    written[rv, c0:c0 + ct] += 1
        assert (written == 1).all()
    return out


def _rows(rng, rows, n_mels):
    mel = rng.uniform(-100.0, 40.0, (rows, n_mels)).astype(np.float32)
    floor = rng.uniform(-60.0, 0.0, rows).astype(np.float32)
    return mel, floor


@pytest.mark.parametrize("rows,n_mels,n_mfcc", [
    (1300, 128, 40),   # six row tiles on four blocks: blocks 0 and 1 walk two
    (1, 128, 40), (63, 128, 40), (65, 128, 13),
    (700, 128, 64), (700, 128, 65), (600, 128, 128),   # two to four coefficient tiles
    (600, 40, 40), (600, 512, 40), (300, 1000, 40),   # 1000 mels: two launches
    (600, 42, 13),                                     # a ragged last chunk
])
def test_restated_floor_dct_matches_plain(rng, rows, n_mels, n_mfcc):
    mel, floor = _rows(rng, rows, n_mels)
    dct = TF.create_dct(n_mfcc, n_mels, "ortho")
    plain = floor_dct_plain(torch.from_numpy(mel), torch.from_numpy(floor),
                            torch.from_numpy(dct)).numpy()
    ours = floor_dct_restated(mel, floor, dct, sms=2)
    assert ours.shape == plain.shape == (rows, n_mfcc)
    assert np.abs(ours - plain).max() <= RTOL * np.abs(plain).max()
    # the wrapper takes every shape on the CPU through its plain version
    np.testing.assert_array_equal(floor_dct(torch.from_numpy(mel), torch.from_numpy(floor),
                                            torch.from_numpy(dct)).numpy(), plain)


@pytest.mark.parametrize("n_mels,want", [(40, (3, 64, 2)), (128, (2, 128, 2)),
                                         (224, (2, 224, 2)), (225, (3, 256, 1)),
                                         (512, (3, 512, 1)), (1000, (2, 832, 1)),
                                         (4096, (2, 832, 1))])
def test_layout_fits_the_card(n_mels, want):
    """Two blocks an SM (two or three 32 KB stages beside the whole basis in
    half of its shared memory) up to 224 mels; one past that, three stages
    up to 672 mels, two and launches of 832 mels past that; always within
    the shared memory a block (or each of two) may take."""
    stages, kr, total, per_sm = layout(n_mels)
    assert (stages, kr, per_sm) == want and kr % KT == 0
    assert total <= (SMEM_HALF if per_sm == 2 else SMEM_LIMIT)


def test_shared_reads_are_conflict_free_and_a_word_feeds_four_fmas():
    """A warp's 8 rows at one logical word fall in 8 distinct 16-byte bank
    groups of a 128-byte line (the swizzle); the floor pass's words g + 4 u
    of rows rl cover each word of the rows once; a lane's 3 basis words of
    its group sit in distinct banks beside the other 3 groups'; and a step of
    4 mels reads 8 x 4 mel words and 4 x 12 basis words for 8 x 10 x 4 FMAs."""
    for base in (0, 64, 192):
        for w in range(KT // 4):
            groups = {(((base + rl) * KT + 4 * (w ^ swz(base + rl))) % 32) // 4 for rl in range(8)}
            assert len(groups) == 8
    seen = sorted((rl, (g + 4 * u) ^ swz(rl)) for rl in range(8) for g in range(GROUPS)
                  for u in range(KT // 16))
    assert seen == [(rl, w) for rl in range(8) for w in range(KT // 4)]
    for word in range(CPAD // 4):
        banks = {(g * CPAD + 4 * word) % 32 // 4 for g in range(GROUPS)}
        assert len(banks) == GROUPS
    words, fmas = 8 * 4 + 4 * CPAD, 8 * CPL * 4
    assert words / fmas <= 1 / 4


def _padded(rng, lengths, n_fft):
    pad = n_fft // 2
    rows = [np.pad(speechlike(rng, n), (pad, pad), mode="reflect") for n in lengths]
    out = np.zeros((len(rows), max(len(r) for r in rows)), np.float32)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


@pytest.mark.parametrize("n_mels,n_mfcc", [(128, 40), (128, 80), (128, 128), (512, 40)])
def test_restated_matches_pallas_mfcc_floor_dct_stage(rng, n_mels, n_mfcc):
    """On JAX's own mel, the restated kernel equals ``pallas_mfcc``'s floor
    + DCT stage (any n_mfcc: its basis is one whole block; 512 mels at n_fft
    400 hold bands with no frequency bin, -100 dB)."""
    padded = _padded(rng, (7000, 4000), 400)
    t = (padded.shape[1] - 400) // 200 + 1
    jmel = np.asarray(pallas_mel_spectrogram(jnp.asarray(padded), n_fft=400, hop=200,
                                             n_mels=n_mels, tile=32, interpret=True))[:, :t]
    theirs = np.asarray(pallas_mfcc(jnp.asarray(padded), n_mfcc=n_mfcc, n_mels=n_mels,
                                    tile=32, interpret=True))
    floor = np.repeat(jmel.max(axis=(1, 2)) - 80.0, t).astype(np.float32)
    ours = floor_dct_restated(jmel.reshape(-1, n_mels), floor,
                              TF.create_dct(n_mfcc, n_mels, "ortho")).reshape(2, t, n_mfcc)
    assert theirs.shape == ours.shape
    assert np.abs(ours - theirs).max() <= RTOL * np.abs(theirs).max()
    if n_mels == 512:
        assert (jmel == -100.0).all(axis=(0, 1)).any()


@pytest.mark.parametrize("n_fft,n_mels", [(1024, 320), (2048, 512)])
def test_mel_plain_takes_wide_banks_as_jax_does(rng, n_fft, n_mels):
    """The widths both kernels now take past 256 mels: the plain version
    (which the kernels are held to on the card) against JAX's f32 kernel,
    empty bands (no frequency bin at n_fft 1024) at -100 dB on both sides."""
    padded = _padded(rng, (6000, 4000), n_fft)
    t = (padded.shape[1] - n_fft) // 160 + 1
    ours = M.mel_db_plain(torch.from_numpy(padded), t, n_fft, 160, n_mels).numpy()
    theirs = np.asarray(pallas_mel_spectrogram(jnp.asarray(padded), n_fft=n_fft, hop=160,
                                               n_mels=n_mels, tile=32, interpret=True))[:, :t]
    assert ours.shape == (2, t, n_mels)
    np.testing.assert_allclose(ours, theirs, atol=2e-2)
    empty = (ours == -100.0).all(axis=(0, 1))
    assert np.array_equal(empty, (theirs == -100.0).all(axis=(0, 1)))
    if n_fft == 1024:
        assert empty.any()
