"""Audio feature frontend in PyTorch: mel spectrogram and MFCC.

The counterpart of ``sept_tpu/ops/frontend.py``.  The constant tables are
built in numpy exactly as there (float64 inside, float32 at the edge), so
both packages feed their GEMMs bit-identical operands.  The functions below
are plain torch ops on one utterance; the fused CUDA kernels for the same
chains over batches live in :mod:`sept_tpu_torch.ops.mel` (log-mel) and
:mod:`sept_tpu_torch.ops.mfcc` (top_db floor + DCT).

Precision: the port holds f32 parity with TF32 switched off
(``torch.backends.cuda.matmul.allow_tf32 = False``, set by the entry
points), the counterpart of the JAX package's ``PARITY_PRECISION = HIGHEST``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "pcm_to_float",
    "hann_window",
    "hz_to_mel",
    "mel_to_hz",
    "melscale_fbanks",
    "rdft_matrices",
    "frame_signal",
    "stft_power",
    "amplitude_to_db",
    "mel_spectrogram",
    "create_dct",
    "mfcc",
    "np_gradient",
    "mfcc_with_deltas",
]


def pcm_to_float(x: torch.Tensor) -> torch.Tensor:
    """int16 PCM -> float32 in [-1, 1); float input passes through.

    The multiply by the exact power of two 2^-15 is bit-equal to
    torchaudio's int16 load normalization, so int16 may cross host -> device
    at half the bytes of float32 and be normalized there.
    """
    if x.dtype == torch.int16:
        return x.to(torch.float32) * (1.0 / 32768.0)
    return x


# ---------------------------------------------------------------------------
# Constant tables (numpy, float64 internally, float32 at the edge).  Each is
# cached for the process and returned read-only: a caller's in-place write
# would otherwise change every later user's table.  Tensors are made from
# them by copy (``torch.tensor``), never by ``torch.from_numpy``, whose CPU
# tensor would share the cached storage.


def _frozen(*arrays):
    for a in arrays:
        a.setflags(write=False)
    return arrays if len(arrays) > 1 else arrays[0]


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int, periodic: bool = True) -> np.ndarray:
    """Hann window matching ``torch.hann_window(win_length, periodic=True)``."""
    n = win_length if periodic else win_length - 1
    k = np.arange(win_length, dtype=np.float64)
    return _frozen((0.5 - 0.5 * np.cos(2.0 * math.pi * k / n)).astype(np.float32))


def hz_to_mel(freq, mel_scale: str = "htk"):
    """HTK mel scale 2595 * log10(1 + f/700), or Slaney's."""
    freq = np.asarray(freq, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + freq / 700.0)
    f_sp = 200.0 / 3.0
    min_log_mel = 1000.0 / f_sp
    logstep = math.log(6.4) / 27.0
    with np.errstate(divide="ignore"):  # log(0) lands in the unused branch
        log_part = min_log_mel + np.log(freq / 1000.0) / logstep
    return np.where(freq >= 1000.0, log_part, freq / f_sp)


def mel_to_hz(mels, mel_scale: str = "htk"):
    mels = np.asarray(mels, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    f_sp = 200.0 / 3.0
    min_log_mel = 1000.0 / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    1000.0 * np.exp(logstep * (mels - min_log_mel)),
                    f_sp * mels)


@functools.lru_cache(maxsize=None)
def melscale_fbanks(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
    norm: str | None = None,
    mel_scale: str = "htk",
) -> np.ndarray:
    """Triangular mel filterbank, (n_freqs, n_mels).

    Matches ``torchaudio.functional.melscale_fbanks``, including its
    ``linspace(0, sample_rate // 2, n_freqs)`` with integer floor division.
    """
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min, mel_scale), hz_to_mel(f_max, mel_scale),
                        n_mels + 2)
    f_pts = mel_to_hz(m_pts, mel_scale)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = (-1.0 * slopes[:, :-2]) / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        fb *= (2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels]))[None, :]
    return _frozen(fb.astype(np.float32))


@functools.lru_cache(maxsize=None)
def rdft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Real-DFT cos/sin tables, each (n_fft, n_fft//2 + 1).

    ``frames @ cos`` is Re(rfft); ``frames @ sin`` is -Im(rfft), which
    squares to the same power.
    """
    t = np.arange(n_fft, dtype=np.float64)[:, None]
    f = np.arange(n_fft // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * math.pi * t * f / n_fft
    return _frozen(np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


@functools.lru_cache(maxsize=None)
def create_dct(n_mfcc: int, n_mels: int, norm: str | None = "ortho") -> np.ndarray:
    """DCT-II basis, (n_mels, n_mfcc), as ``torchaudio.functional.create_dct``."""
    n = np.arange(n_mels, dtype=np.float64)
    k = np.arange(n_mfcc, dtype=np.float64)[:, None]
    dct = np.cos(math.pi / n_mels * (n + 0.5) * k)  # (n_mfcc, n_mels)
    if norm is None:
        dct *= 2.0
    elif norm == "ortho":
        dct[0] *= 1.0 / math.sqrt(2.0)
        dct *= math.sqrt(2.0 / n_mels)
    else:
        raise ValueError(f"unsupported DCT norm: {norm!r}")
    return _frozen(dct.T.astype(np.float32))


# ---------------------------------------------------------------------------
# STFT / spectrogram


def frame_signal(wave: torch.Tensor, n_fft: int, hop_length: int,
                 center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """Overlapping frames of a 1-D waveform, (n_frames, n_fft).

    ``center=True`` reflect-pads n_fft//2 on each side, as ``torch.stft``.
    """
    if center:
        pad = n_fft // 2
        wave = torch.nn.functional.pad(wave[None, None], (pad, pad),
                                       mode=pad_mode)[0, 0]
    return wave.unfold(-1, n_fft, hop_length)


def stft_power(wave: torch.Tensor, n_fft: int, hop_length: int,
               center: bool = True, pad_mode: str = "reflect") -> torch.Tensor:
    """Power spectrogram of a 1-D waveform, (n_freq, n_frames): Hann window,
    onesided, not normalized, the DFT as two GEMMs."""
    frames = frame_signal(wave, n_fft, hop_length, center, pad_mode)
    dev = wave.device
    frames = frames * torch.tensor(hann_window(n_fft), device=dev)
    cos_m, sin_m = (torch.tensor(m, device=dev) for m in rdft_matrices(n_fft))
    re = frames @ cos_m
    im = frames @ sin_m
    return (re * re + im * im).T


def amplitude_to_db(x: torch.Tensor, stype: str = "power",
                    top_db: float | None = None, amin: float = 1e-10,
                    ref: float = 1.0) -> torch.Tensor:
    """``torchaudio.transforms.AmplitudeToDB``.  ``top_db`` floors at the max
    of the whole input up to 3 dims (one utterance: the reference's
    per-utterance convention); a batched input of more than 3 dims is floored
    item by item, at each item's max over its trailing 3 axes."""
    multiplier = 10.0 if stype == "power" else 20.0
    db = multiplier * torch.log10(torch.clamp(x, min=amin))
    db = db - multiplier * math.log10(max(amin, ref))
    if top_db is not None:
        peak = db.max() if db.dim() <= 3 else db.amax(dim=(-3, -2, -1), keepdim=True)
        db = torch.maximum(db, peak - top_db)
    return db


def mel_spectrogram(wave: torch.Tensor, n_fft: int = 1024, hop_length: int = 160,
                    n_mels: int = 128, sample_rate: int = 16000,
                    f_min: float = 0.0, f_max: float | None = None,
                    to_db: bool = True,
                    top_db: float | None = None) -> torch.Tensor:
    """Log-mel spectrogram of a 1-D waveform, (n_mels, n_frames): the
    reference's ``mel_spectrogram()`` helper (hop 160, Hann, power 2)."""
    if f_max is None:
        f_max = float(sample_rate // 2)
    spec = stft_power(wave, n_fft, hop_length)
    fb = torch.tensor(melscale_fbanks(n_fft // 2 + 1, f_min, f_max, n_mels, sample_rate),
                      device=wave.device)
    mel = (spec.T @ fb).T
    return amplitude_to_db(mel, "power", top_db) if to_db else mel


def mfcc(wave: torch.Tensor, sample_rate: int = 16000, n_mfcc: int = 40,
         n_fft: int = 400, hop_length: int = 200, n_mels: int = 128,
         top_db: float = 80.0) -> torch.Tensor:
    """MFCC of a 1-D waveform, (n_mfcc, n_frames), as
    ``torchaudio.transforms.MFCC`` with its defaults: mel n_fft 400, hop 200,
    128 mels, AmplitudeToDB('power', top_db 80), DCT-II ortho."""
    mel = mel_spectrogram(wave, n_fft=n_fft, hop_length=hop_length, n_mels=n_mels,
                          sample_rate=sample_rate, top_db=top_db)
    dct = torch.tensor(create_dct(n_mfcc, n_mels, "ortho"), device=wave.device)
    return (mel.T @ dct).T


def np_gradient(x: torch.Tensor, spacing: float = 1.0) -> torch.Tensor:
    """``np.gradient`` of a 1-D tensor: central differences, one-sided edges.

    The reference's "second derivative" ``np.gradient(audio, 2)`` passes 2
    as a *spacing*, so it is the first gradient halved; kept as it is.
    """
    interior = (x[2:] - x[:-2]) / (2.0 * spacing)
    left = (x[1] - x[0]) / spacing
    right = (x[-1] - x[-2]) / spacing
    return torch.cat([left[None], interior, right[None]])


def mfcc_with_deltas(wave: torch.Tensor) -> torch.Tensor:
    """The reference's 120-dim MFCC stack, (120, n_frames): the MFCC of the
    wave, of its gradient, and of its gradient at spacing 2 (MFCCs of the
    differentiated waveform, not delta-MFCCs)."""
    return torch.cat([mfcc(wave), mfcc(np_gradient(wave, 1.0)),
                      mfcc(np_gradient(wave, 2.0))], dim=0)
