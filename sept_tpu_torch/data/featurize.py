"""Batched corpus featurization: one upload of each wave chunk feeds the
spectral features of the reference's feature store.

Counterpart of ``sept_tpu/data/featurize.py``.  Waveforms are bucketed by
length and each chunk crosses host -> device once as raw zero-padded rows;
the reflect padding at each row's true boundary (center-STFT semantics) and
the ``np.gradient`` derivatives of the MFCC path are computed on the device
from the true sample counts.

Store schema, per utterance, each trimmed to ``1 + n // hop`` frames (a
copy, not a view of the chunk):

- ``feature_type="mel_spec"``: ``mel1`` (feature_len, T), n_fft 800, and
  ``mel2`` (feature_len, T), n_fft 1600, hop 160, dB with no floor;
- ``feature_type="mfcc"``: ``mfcc`` (120, T), hop 200: the MFCCs of the
  wave and of its two gradients (spacings 1 and 2).

- with ``include_gemaps`` / ``include_emobase``: ``gemaps`` (88,) and
  ``emobase`` (988,), the functionals of :mod:`sept_tpu_torch.ops.egemaps`
  and :mod:`sept_tpu_torch.ops.emobase` on the same staged chunk (one STFT
  preamble and one YIN pitch for both).

On a card the mel goes through the f32 mel kernel and the MFCC's top_db
floor + DCT through the floor + DCT kernel (``ops/mfcc.py``); the JAX
package computes the same functions with XLA ops.  The functionals are
torch ops on the same device, as they are plain XLA ops in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from sept_tpu_torch.device import f32_precision, resolve_device
from sept_tpu_torch.ops import frontend as F
from sept_tpu_torch.ops import functionals as FN
from sept_tpu_torch.ops.emobase import functionals_chunk
from sept_tpu_torch.ops.mel import mel_db
from sept_tpu_torch.ops.mfcc import dct_basis, floor_dct

__all__ = ["featurize_corpus", "feature_frames", "device_reflect_pad"]

_HOP = 160  # reference mel hop
_MFCC_HOP = 200  # torchaudio MFCC default hop
_MFCC_FFT, _N_MFCC, _MFCC_MELS, _TOP_DB = 400, 40, 128, 80.0


def feature_frames(n_samples: int, hop: int) -> int:
    """Frame count of a center-padded STFT: 1 + n // hop."""
    return 1 + n_samples // hop


def device_reflect_pad(W: torch.Tensor, ns: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad each row at its true boundary, as a gather on W's device.

    ``W`` (rows, L) zero-padded past each row's true length ``ns``; returns
    (rows, L + 2*pad) where row r is ``np.pad(w[:n], pad, mode='reflect')``
    followed by zeros.  The periodic fold (period 2(n-1), np.pad's
    multi-reflection rule) is exact for any pad, also for rows shorter than
    the pad.
    """
    length = W.shape[1]
    p = torch.arange(length + 2 * pad, device=W.device)[None, :]
    n = ns.to(torch.long)[:, None]
    period = torch.clamp(2 * (n - 1), min=1)
    m = torch.remainder(p - pad, period)  # non-negative, as Python's %
    idx = torch.where(n > 1, torch.minimum(m, period - m), 0)
    out = torch.gather(W, 1, torch.clamp(idx, 0, length - 1))
    return torch.where(p < n + 2 * pad, out, 0.0)


def _padded_gradient(W: torch.Tensor, ns: torch.Tensor, spacing: float) -> torch.Tensor:
    """``np.gradient(w[:n], spacing)`` per row of a zero-padded batch:
    central differences, one-sided at the true boundaries 0 and n-1, zeros
    beyond."""
    length = W.shape[1]
    xm1 = torch.nn.functional.pad(W[:, :-1], (1, 0))
    xp1 = torch.nn.functional.pad(W[:, 1:], (0, 1))
    g = (xp1 - xm1) / (2.0 * spacing)
    i = torch.arange(length, device=W.device)[None, :]
    n = ns.to(torch.long)[:, None]
    g = torch.where(i == 0, (xp1 - W) / spacing, g)
    g = torch.where(i == n - 1, (W - xm1) / spacing, g)
    return torch.where(i < n, g, 0.0)


def mel_spec_chunk(W: torch.Tensor, ns: torch.Tensor, feature_len: int):
    """(mel1, mel2) of a staged chunk, each (rows, feature_len, T_bucket)."""
    W = F.pcm_to_float(W)
    t = feature_frames(W.shape[1], _HOP)
    out = []
    for n_fft in (800, 1600):
        padded = device_reflect_pad(W, ns, n_fft // 2)
        out.append(mel_db(padded, t, n_fft, _HOP, feature_len).transpose(1, 2))
    return tuple(out)


def mfcc_mel_and_floor(W: torch.Tensor, ns: torch.Tensor):
    """The MFCC path up to the floor + DCT kernel: un-floored mel dB of the
    wave and its two gradients, (3 * rows * T, 128) with the streams in the
    order [wave; gradient; gradient at spacing 2], and each row's floor,
    the max over its utterance's VALID frames minus top_db (frames past
    ``1 + n // 200`` hold reflected tails at alignments the centred STFT
    never produces and must not raise the floor)."""
    W = F.pcm_to_float(W)
    rows = W.shape[0]
    streams = torch.cat([device_reflect_pad(W, ns, _MFCC_FFT // 2),
                         device_reflect_pad(_padded_gradient(W, ns, 1.0), ns, _MFCC_FFT // 2),
                         device_reflect_pad(_padded_gradient(W, ns, 2.0), ns, _MFCC_FFT // 2)])
    t = feature_frames(W.shape[1], _MFCC_HOP)
    mel = mel_db(streams, t, _MFCC_FFT, _MFCC_HOP, _MFCC_MELS)  # (3 rows, T, 128)
    t_valid = (1 + ns.to(torch.long) // _MFCC_HOP).repeat(3)
    valid = torch.arange(t, device=W.device)[None, :] < t_valid[:, None]
    peak = torch.where(valid, mel.amax(dim=2), -torch.inf).amax(dim=1)
    floor = (peak - _TOP_DB).repeat_interleave(t)
    return mel.reshape(3 * rows * t, _MFCC_MELS), floor, t


def mfcc_chunk(W: torch.Tensor, ns: torch.Tensor) -> torch.Tensor:
    """The 120-dim MFCC stack of a staged chunk, (rows, 120, T_bucket)."""
    mel, floor, t = mfcc_mel_and_floor(W, ns)
    coeffs = floor_dct(mel, floor, dct_basis(_N_MFCC, _MFCC_MELS, mel.device))
    rows = W.shape[0]
    # (3, rows, T, 40) -> (rows, 3 * 40, T)
    return coeffs.reshape(3, rows, t, _N_MFCC).permute(1, 0, 3, 2).reshape(
        rows, 3 * _N_MFCC, t)


def featurize_corpus(waveforms: dict[str, np.ndarray], feature_type: str = "mel_spec",
                     feature_len: int = 128, include_gemaps: bool = True,
                     include_emobase: bool | None = None, quantum: int = 8000,
                     batch_size: int = 64, device="cuda") -> dict[str, dict[str, np.ndarray]]:
    """Featurize every waveform (float32 or int16 PCM, 16 kHz) into the
    reference feature-store dict (see the module docstring).

    ``include_emobase`` tracks ``include_gemaps`` when None, as in the JAX
    package.  Each chunk's outputs are copied to the host before the next
    chunk is staged, so the device holds one chunk at a time, not the
    corpus.
    """
    if include_emobase is None:
        include_emobase = include_gemaps
    if feature_type not in ("mel_spec", "mfcc"):
        raise ValueError(f"unknown feature_type: {feature_type!r}")
    dev = resolve_device(device)
    f32_precision()
    hop = _HOP if feature_type == "mel_spec" else _MFCC_HOP
    store: dict[str, dict[str, np.ndarray]] = {u: {} for u in waveforms}
    with torch.no_grad():
        for ids, W, ts, ns in FN.chunked_wave_batches(waveforms, quantum, batch_size,
                                                      FN.n_frames):
            Wd = torch.from_numpy(W).to(dev)
            nsd = torch.from_numpy(ns).to(dev)
            if feature_type == "mel_spec":
                outs = {k: v.cpu().numpy()
                        for k, v in zip(("mel1", "mel2"), mel_spec_chunk(Wd, nsd, feature_len))}
            else:
                outs = {"mfcc": mfcc_chunk(Wd, nsd).cpu().numpy()}
            for row, u in enumerate(ids):
                t = feature_frames(int(ns[row]), hop)
                for key, arr in outs.items():
                    store[u][key] = arr[row, :, :t].copy()
            if include_gemaps or include_emobase:
                vecs = functionals_chunk(Wd, torch.from_numpy(ts).to(dev), nsd,
                                         include_gemaps, include_emobase)
                for key, v in zip(("gemaps", "emobase"), vecs):
                    if v is not None:
                        v = v.cpu().numpy()
                        for row, u in enumerate(ids):
                            store[u][key] = v[row].copy()
    return store
