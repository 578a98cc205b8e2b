"""Host-side waveform staging for the serving path (numpy).

Counterparts of ``sept_tpu/data/device_pipeline.py::prepare_waves`` and
``sept_tpu/ops/functionals.py::pow2_rows``, kept here so the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["HOP", "prepare_waves", "pow2_rows"]

HOP = 160  # 10 ms at 16 kHz


def prepare_waves(waveforms: list[np.ndarray],
                  n_fft: int = 800) -> tuple[np.ndarray, np.ndarray]:
    """Reflect-pad each wave by n_fft//2 at its true boundary (center-STFT
    semantics), zero-pad to the batch max.  Returns (padded (N, Lmax+n_fft),
    n_frames (N,) int32).

    All-int16 input stays int16 (a reflect pad is a permutation, exact in any
    dtype), so it crosses host -> device at half the bytes and is normalized
    there (``ops.frontend.pcm_to_float``).  A mixed batch is normalized here.
    """
    pad = n_fft // 2
    lengths = np.asarray([len(w) for w in waveforms])
    lmax = int(lengths.max())
    frames = (1 + lengths // HOP).astype(np.int32)
    dtype = (np.int16 if all(w.dtype == np.int16 for w in waveforms)
             else np.float32)
    if dtype == np.float32:
        waveforms = [
            w.astype(np.float32) * np.float32(1.0 / 32768.0)
            if w.dtype == np.int16 else w
            for w in waveforms
        ]
    if (lengths == lmax).all():
        stacked = np.ascontiguousarray(np.stack(waveforms).astype(dtype, copy=False))
        return np.pad(stacked, ((0, 0), (pad, pad)), mode="reflect"), frames
    out = np.zeros((len(waveforms), lmax + n_fft), dtype=dtype)
    for i, w in enumerate(waveforms):
        out[i, : len(w) + n_fft] = np.pad(w, (pad, pad), mode="reflect")
    return out, frames


def pow2_rows(n: int, cap: int) -> int:
    """Round a row count up to the next power of two, capped: batch shapes
    stay in a small closed set."""
    r = 1
    while r < min(n, cap):
        r *= 2
    return min(r, cap)
