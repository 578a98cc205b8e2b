"""Fused log-mel spectrogram: the CUDA kernels' wrappers and their plain version.

Counterpart of ``sept_tpu/ops/pallas_frontend.py::_mel_kernel`` in both of
its modes.  :func:`mel_db` launches ``csrc/mel.cu``'s f32 kernel for a CUDA
tensor, or with ``bf16=True`` hands over to :func:`mel_db_bf16`, which
launches the bf16 kernel (operands rounded to bf16 at the TPU kernel's six
places, f32 accumulation; the throughput mode).  Each mode has its own launch
count.  A CPU tensor runs :func:`mel_db_plain` in the same mode; any other
input raises.

The f32 kernel is FFT-structured, one launch a call: a real FFT of n_fft (a
complex FFT of M = n_fft / 2 for an even n_fft, of M = n_fft for an odd one)
in radix-4, 2, 5 and 3 Stockham passes -- or, where M has a prime factor
above 5, Bluestein's convolution of a 2-3-5-smooth length in those passes --
in float64, then the f32 power and the sparse mel bank.  It takes any n_fft
>= 2 (:func:`fft_radices` refuses smaller ones before a launch); only a
shape whose buffers do not fit a block of one warp raises, by its shared
memory.  :func:`fft_plan` (radices and float64 twiddles) and
:func:`sparse_bank` (each band's first bin, bin count and weights) are the
kernel's tables, built once per (n_fft, device).

The filterbank spans 0-8 kHz at 16 kHz over n_mels triangles: by default
on the HTK mel scale with no norm (the JAX package's), or, with
``mel_scale="slaney", norm="slaney"``, Whisper's (Slaney's scale, each band
scaled to unit area).  Only the f32 mode takes the Slaney bank.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from sept_tpu_torch.ops import cuda_lib
from sept_tpu_torch.ops import frontend as F

__all__ = ["mel_db", "mel_db_bf16", "mel_db_plain", "fft_length", "bluestein_length",
           "fft_radices", "fft_plan", "sparse_bank", "AMIN"]

AMIN = 1e-10  # the AmplitudeToDB power clamp
_RADICES = (4, 2, 5, 3)  # the kernel's Stockham passes, in the order they run


def _bank(n_fft: int, n_mels: int, mel_scale: str, norm: Optional[str]) -> np.ndarray:
    """The dense (n_fft // 2 + 1, n_mels) f32 filterbank, 0-8 kHz at 16 kHz."""
    return F.melscale_fbanks(n_fft // 2 + 1, 0.0, 8000.0, n_mels, 16000, norm=norm,
                             mel_scale=mel_scale)


@functools.lru_cache(maxsize=None)
def _tables(n_fft: int, n_mels: int, device: torch.device, mel_scale: str = "htk",
            norm: Optional[str] = None):
    """(window, cos, sin, filterbank) as f32 tensors on ``device``."""
    cos_m, sin_m = F.rdft_matrices(n_fft)
    fb = _bank(n_fft, n_mels, mel_scale, norm)
    return tuple(torch.tensor(a, device=device)
                 for a in (F.hann_window(n_fft), cos_m, sin_m, fb))


@functools.lru_cache(maxsize=None)
def _tables_bf16(n_fft: int, n_mels: int, device: torch.device):
    """The f32 tables rounded to bf16 (round to nearest even, as the JAX
    package's ``astype``): (window, cos, sin, filterbank)."""
    return tuple(t.to(torch.bfloat16) for t in _tables(n_fft, n_mels, device))


def swizzle_tile(tile: torch.Tensor) -> torch.Tensor:
    """A (rows, 64) bf16 tile in the 128-byte swizzle that the bf16 kernel's
    ``wgmma`` reads: row r's 16-byte group c (taps 8c .. 8c + 7) stored at
    group c ^ (r % 8).  Its own inverse."""
    rows = tile.shape[0]
    r = torch.arange(rows)[:, None]
    src = tile.reshape(rows, 8, 8)
    out = torch.empty_like(src)
    out[r, torch.arange(8)[None, :] ^ (r % 8)] = src
    return out.reshape(rows, 64)


def bf16_chunks(n_fft: int, geometry: tuple) -> list[int]:
    """The bf16 kernel's frequency chunks: ``nc`` frequencies each, the last
    cut to a multiple of ``align`` (its tile has twice that many rows)."""
    nc, align = geometry[0], geometry[4]
    n_freq = n_fft // 2 + 1
    chunks = -(-n_freq // nc)
    tail = n_freq - nc * (chunks - 1)
    return [nc] * (chunks - 1) + [-(-tail // align) * align]


@functools.lru_cache(maxsize=None)
def _kernel_tables_bf16(n_fft: int, n_mels: int, geometry: tuple, device: torch.device):
    """The bf16 kernel's operands: the window; the cos/sin table, per chunk
    (:func:`bf16_chunks`) and slab of ``ks`` taps one swizzled tile
    (:func:`swizzle_tile`) of 2 x (the chunk's frequencies) rows, cos and
    sin of a frequency interleaved, over the slab's taps (zeros past n_fft
    and past the last frequency); the filterbank, per pass of ``mel_tile``
    mels and chunk one swizzled tile of ``mel_tile`` rows over the chunk's
    frequencies; and the masks (passes, chunks) uint8,
    bit s set where the tile's rows s * mel_sub .. (s + 1) * mel_sub - 1
    hold a nonzero."""
    nc, ks, mel_tile, mel_sub, _ = geometry
    window, cos_m, sin_m, fb = _tables_bf16(n_fft, n_mels, torch.device("cpu"))
    n_freq = n_fft // 2 + 1
    widths = bf16_chunks(n_fft, geometry)
    k_pad = -(-n_fft // ks) * ks
    cs = torch.zeros((k_pad, len(widths) * nc, 2), dtype=torch.bfloat16)
    cs[:n_fft, :n_freq, 0] = cos_m
    cs[:n_fft, :n_freq, 1] = sin_m
    tiles = []
    for c, width in enumerate(widths):
        cols = cs[:, c * nc:c * nc + width].reshape(k_pad, 2 * width).T
        tiles += [swizzle_tile(cols[:, k:k + ks]).reshape(-1) for k in range(0, k_pad, ks)]
    passes = -(-n_mels // mel_tile)
    fbp = torch.zeros((len(widths) * nc, passes * mel_tile), dtype=torch.bfloat16)
    fbp[:n_freq, :n_mels] = fb
    banks, masks = [], torch.zeros((passes, len(widths)), dtype=torch.uint8)
    for p in range(passes):
        for c in range(len(widths)):
            blk = fbp[c * nc:(c + 1) * nc, p * mel_tile:(p + 1) * mel_tile].T.contiguous()
            for sub in range(mel_tile // mel_sub):
                if blk[sub * mel_sub:(sub + 1) * mel_sub].float().any():
                    masks[p, c] |= 1 << sub
            banks.append(swizzle_tile(blk).reshape(-1))
    return tuple(t.contiguous().to(device) for t in (window, torch.cat(tiles),
                                                     torch.cat(banks), masks))


def fft_length(n_fft: int) -> int:
    """The length M of the complex FFT the f32 kernel computes: n_fft / 2
    for an even n_fft (the half-length packing), n_fft for an odd one."""
    return n_fft if n_fft % 2 else n_fft // 2


def _passes(m: int) -> tuple[list[int], int]:
    """m's passes -- as many radix-4 as divide it, then 2, 5, 3 -- and the
    part of m they leave (1 where m is 2-3-5-smooth)."""
    out = []
    for r in _RADICES:
        while m % r == 0:
            out.append(r)
            m //= r
    return out, m


def bluestein_length(n_fft: int) -> int:
    """0 where M (:func:`fft_length`) is 2-3-5-smooth and the kernel runs its
    own passes; else the length of the cyclic convolution that computes M's
    DFT (Bluestein): the least 2-3-5-smooth length >= 2M - 1."""
    m = fft_length(n_fft)
    if _passes(m)[1] == 1:
        return 0
    n = 2 * m - 1
    while _passes(n)[1] != 1:
        n += 1
    return n


def fft_radices(n_fft: int) -> tuple[int, ...]:
    """The f32 kernel's Stockham passes, radix 4, 2, 5 and 3 in that order:
    of M (:func:`fft_length`), or, where M has a prime factor above 5, of
    the Bluestein length (:func:`bluestein_length`).  Raises ``ValueError``
    for n_fft < 2."""
    if n_fft < 2:
        raise ValueError(f"mel_db: n_fft must be >= 2, got {n_fft}")
    return tuple(_passes(bluestein_length(n_fft) or fft_length(n_fft))[0])


def fft_plan(n_fft: int) -> tuple[tuple[int, ...], np.ndarray]:
    """(radices, tables) of the f32 kernel's FFT, complex128 as the kernel
    takes them: for each pass of radix R over p combined points, exp(-2 pi
    i r k / (p R)) for k < p, r = 1..R-1 (k major); for an even n_fft the
    split post-pass's exp(-2 pi i k / n_fft) for k = 0..n_fft/4; for Bluestein
    (length F) last the chirp w[n] = exp(-pi i n^2 / M) for n < M and the
    spectrum of the wrapped filter conj(w), FFT_F(h) / F."""
    radices = fft_radices(n_fft)
    parts, p = [], 1
    for r in radices:
        k, rr = np.arange(p)[:, None], np.arange(1, r)[None, :]
        parts.append(np.exp(-2j * np.pi * k * rr / (p * r)).ravel())
        p *= r
    if n_fft % 2 == 0:
        parts.append(np.exp(-2j * np.pi * np.arange(n_fft // 4 + 1) / n_fft))
    f = bluestein_length(n_fft)
    if f:
        m = fft_length(n_fft)
        n = np.arange(m, dtype=np.int64)
        chirp = np.exp(-1j * np.pi * ((n * n) % (2 * m)) / m)
        h = np.zeros(f, np.complex128)
        h[:m] = chirp.conj()
        h[f - m + 1:] = chirp[1:].conj()[::-1]
        parts += [chirp, np.fft.fft(h) / f]
    return radices, np.concatenate(parts)


def sparse_bank(n_fft: int, n_mels: int, mel_scale: str = "htk",
                norm: Optional[str] = None) -> tuple[np.ndarray, np.ndarray]:
    """The mel filterbank of :func:`mel_db` as the kernel reads it:
    ``index`` (3, n_mels) int32 -- each band's first bin, its bin count (its
    nonzeros are contiguous; 0 for an empty band) and its offset into
    ``weights`` -- and ``weights``, the bands' f32 values from the dense
    table, one band after another.  ``mel_scale`` and ``norm`` as
    ``frontend.melscale_fbanks`` takes them."""
    fb = _bank(n_fft, n_mels, mel_scale, norm)
    index = np.zeros((3, n_mels), np.int32)
    weights = []
    for m in range(n_mels):
        nz = np.nonzero(fb[:, m])[0]
        first, count = (int(nz[0]), int(nz[-1] - nz[0] + 1)) if len(nz) else (0, 0)
        index[:, m] = first, count, sum(len(w) for w in weights)
        weights.append(fb[first:first + count, m])
    return index, np.concatenate(weights).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _fft_tables(n_fft: int, n_mels: int, device: torch.device, mel_scale: str = "htk",
                norm: Optional[str] = None):
    """The f32 kernel's operands on ``device``: (radices, window, twiddles as
    interleaved float64 pairs, bank index, bank weights)."""
    radices, tw = fft_plan(n_fft)
    index, weights = sparse_bank(n_fft, n_mels, mel_scale, norm)
    pairs = np.stack([tw.real, tw.imag], -1).ravel()
    return (radices,) + tuple(torch.tensor(a, device=device) for a in (
        F.hann_window(n_fft), pairs, index, weights))


def _check_geometry(padded_waves, n_frames_max, n_fft, hop):
    if padded_waves.dim() != 2:
        raise ValueError(f"padded_waves must be (B, L), got {tuple(padded_waves.shape)}")
    need = (n_frames_max - 1) * hop + n_fft
    if n_frames_max < 1 or padded_waves.shape[1] < need:
        raise ValueError(
            f"{n_frames_max} frames of n_fft {n_fft} at hop {hop} need "
            f">= {need} samples a row, got {padded_waves.shape[1]}")


def mel_db_plain(padded_waves: torch.Tensor, n_frames_max: int,
                 n_fft: int = 800, hop: int = 160, n_mels: int = 128,
                 bf16: bool = False, mel_scale: str = "htk",
                 norm: Optional[str] = None) -> torch.Tensor:
    """The same function in plain torch: frames -> Hann -> rDFT GEMMs ->
    power -> mel GEMM -> 10*log10(max(., 1e-10)), (B, T, n_mels).

    ``bf16``: round to bf16 where the TPU kernel's bf16 mode does -- the
    waveform, the window, their product (one bf16 multiply), the cos/sin
    tables, the f32 power and the filterbank -- and multiply in f32 (exact
    for bf16 operands; TF32 off), accumulating in f32.  ``mel_scale`` /
    ``norm``: the bank (HTK alone in bf16).
    """
    padded_waves = F.pcm_to_float(padded_waves)
    _check_geometry(padded_waves, n_frames_max, n_fft, hop)
    _check_bank(bf16, mel_scale, norm)
    if not bf16:
        window, cos_m, sin_m, fb = _tables(n_fft, n_mels, padded_waves.device, mel_scale, norm)
        frames = padded_waves.unfold(1, n_fft, hop)[:, :n_frames_max] * window
        re = frames @ cos_m
        im = frames @ sin_m
        power = re * re + im * im
        return 10.0 * torch.log10(torch.clamp(power @ fb, min=AMIN))
    window, cos_m, sin_m, fb = _tables_bf16(n_fft, n_mels, padded_waves.device)
    waves = padded_waves.to(torch.bfloat16)
    frames = (waves.unfold(1, n_fft, hop)[:, :n_frames_max] * window).float()
    re = frames @ cos_m.float()
    im = frames @ sin_m.float()
    power = (re * re + im * im).to(torch.bfloat16).float()
    return 10.0 * torch.log10(torch.clamp(power @ fb.float(), min=AMIN))


def _check_bank(bf16: bool, mel_scale: str, norm: Optional[str]) -> None:
    if bf16 and (mel_scale, norm) != ("htk", None):
        raise ValueError("mel_db: the bf16 mode takes the HTK bank alone")


def mel_db(padded_waves: torch.Tensor, n_frames_max: int, n_fft: int = 800,
           hop: int = 160, n_mels: int = 128, bf16: bool = False, mel_scale: str = "htk",
           norm: Optional[str] = None) -> torch.Tensor:
    """Log-mel spectrogram in dB (top_db None) of reflect-padded waveforms.

    ``padded_waves`` (B, L) f32, or int16 PCM (normalized here, exactly),
    each row reflect-padded by n_fft//2 at its true boundary; frame t reads
    samples [t*hop, t*hop + n_fft).  Returns (B, n_frames_max, n_mels) f32.
    Filterbank: 0-8 kHz, 16 kHz, HTK without a norm unless ``mel_scale`` and
    ``norm`` say otherwise (``"slaney"``, ``"slaney"``: Whisper's).
    ``bf16``: the throughput mode, see :func:`mel_db_bf16`, HTK alone.
    """
    _check_bank(bf16, mel_scale, norm)
    if bf16:
        return mel_db_bf16(padded_waves, n_frames_max, n_fft, hop, n_mels)
    dev = padded_waves.device
    if dev.type == "cpu":
        return mel_db_plain(padded_waves, n_frames_max, n_fft, hop, n_mels, mel_scale=mel_scale,
                            norm=norm)
    padded_waves = F.pcm_to_float(padded_waves)
    _check_geometry(padded_waves, n_frames_max, n_fft, hop)
    fft_radices(n_fft)
    b, length = padded_waves.shape
    cuda_lib.require(padded_waves, "mel_db padded_waves", (b, length), dev)
    lib = cuda_lib.load("mel")
    radices, window, twiddles, index, weights = _fft_tables(n_fft, n_mels, dev, mel_scale, norm)
    n_tw = twiddles.numel() // 2
    smem = lib.sept_mel_db_smem_bytes(n_fft, hop, int(np.prod(radices)))
    if smem > cuda_lib.max_smem_per_block(dev):
        raise ValueError(f"mel_db: n_fft {n_fft} / hop {hop} need {smem} bytes "
                         "of shared memory a block, above the card's limit")
    out = torch.empty((b, n_frames_max, n_mels), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    err = lib.sept_mel_db(
        padded_waves.data_ptr(), window.data_ptr(), twiddles.data_ptr(),
        index.data_ptr(), weights.data_ptr(), out.data_ptr(), b, length, n_frames_max,
        n_fft, hop, n_mels, n_tw, (ctypes.c_int * max(len(radices), 1))(*radices),
        len(radices), cuda_lib.stream_of(out))
    cuda_lib.check(lib, err, "mel_db")
    mel_db.launches += 1
    return out


mel_db.launches = 0  # f32 kernel launches since the last reset


def mel_db_bf16(padded_waves: torch.Tensor, n_frames_max: int, n_fft: int = 800,
                hop: int = 160, n_mels: int = 128) -> torch.Tensor:
    """:func:`mel_db` in the bf16 mode: the tensor-core kernel on a CUDA
    tensor, ``mel_db_plain(..., bf16=True)`` on a CPU tensor."""
    dev = padded_waves.device
    if dev.type == "cpu":
        return mel_db_plain(padded_waves, n_frames_max, n_fft, hop, n_mels, bf16=True)
    padded_waves = F.pcm_to_float(padded_waves)
    _check_geometry(padded_waves, n_frames_max, n_fft, hop)
    b, length = padded_waves.shape
    cuda_lib.require(padded_waves, "mel_db_bf16 padded_waves", (b, length), dev)
    lib = cuda_lib.load("mel")
    if n_fft < 2:
        raise ValueError(f"mel_db_bf16: n_fft must be >= 2, got {n_fft}")
    smem = lib.sept_mel_bf16_smem_bytes(n_fft)
    if smem > cuda_lib.max_smem_per_block(dev):
        raise ValueError(f"mel_db_bf16: n_fft {n_fft} needs {smem} bytes of shared "
                         "memory a block, above the card's limit")
    geometry = (ctypes.c_int * 5)()
    lib.sept_mel_bf16_geometry(geometry)
    window, table, bank, masks = _kernel_tables_bf16(n_fft, n_mels, tuple(geometry), dev)
    out = torch.empty((b, n_frames_max, n_mels), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    err = lib.sept_mel_db_bf16(
        padded_waves.data_ptr(), window.data_ptr(), table.data_ptr(), bank.data_ptr(),
        masks.data_ptr(), out.data_ptr(), b, length, n_frames_max, n_fft, hop, n_mels,
        cuda_lib.stream_of(out))
    cuda_lib.check(lib, err, "mel_db_bf16")
    mel_db_bf16.launches += 1
    return out


mel_db_bf16.launches = 0  # bf16 kernel launches since the last reset
