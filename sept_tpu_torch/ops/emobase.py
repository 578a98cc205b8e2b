"""988-dimensional emobase-style functionals.

Counterpart of ``sept_tpu/ops/emobase.py``: 26 low-level descriptors and
their deltas (52 tracks) x 19 functionals, openSMILE emobase's width with
the JAX package's catalog (the catalog and its divergences from openSMILE
are in that module's docstring).  Layout: dimension ``lld * 19 + f`` is
functional ``f`` of track ``lld``.

The tracks come from the same batched torch ops as
:mod:`sept_tpu_torch.ops.egemaps` (the shared STFT preamble and YIN
pitch), and the 19 functionals are masked reductions over all 52 tracks of
a bucket at once.  The F0 envelope, a scan over frames in the JAX package
(``e_t = max(x_t, 0.95 e_{t-1})``), is its closed form here:
``e_t = max_{s <= t} 0.95^(t - s) x_s`` for x >= 0, a cumulative max in the
log domain (float64), one launch a bucket where a loop would take one a
frame.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from sept_tpu_torch.ops import egemaps as EG
from sept_tpu_torch.ops import frontend as F
from sept_tpu_torch.ops import functionals as FN

__all__ = ["N_EMOBASE", "N_LLD", "N_FUNCTIONALS", "combined_functionals_batch",
           "emobase_functionals", "emobase_functionals_batch", "f0_envelope"]

N_LLD = 52  # 26 tracks and their deltas
N_FUNCTIONALS = 19
N_EMOBASE = N_LLD * N_FUNCTIONALS  # 988, openSMILE emobase's width
_SR = 16000
_NFREQ = FN.NFREQ
_EPS = 1e-10
_DECAY = 0.95


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """The constant tables of :func:`_lld`, copied to ``device`` once."""
    tabs = {"mel_fb": F.melscale_fbanks(_NFREQ, 0.0, 8000.0, 26, _SR),
            "dct": F.create_dct(12, 26, "ortho"), "bands": _lsp_band_matrix()}
    return {k: torch.tensor(v, device=device) for k, v in tabs.items()}


def _lsp_band_matrix() -> np.ndarray:
    """8 octave-spaced rectangular bands (the LSP stand-ins), (NFREQ, 8)."""
    edges = np.geomspace(100, 8000, 9)
    f = np.linspace(0, _SR / 2, _NFREQ)
    bands = np.zeros((_NFREQ, 8), dtype=np.float32)
    for b in range(8):
        bands[:, b] = ((f >= edges[b]) & (f < edges[b + 1])).astype(np.float32)
    return bands


def f0_envelope(x: torch.Tensor) -> torch.Tensor:
    """The exponential-decay running max ``e_t = max(x_t, 0.95 e_{t-1})``
    (e_{-1} = 0) over the last axis of x >= 0, as
    ``exp(t c + cummax_s(log x_s - s c))`` with c = log 0.95, in float64
    (no overflow at any length: the terms grow as 0.0513 t)."""
    c = math.log(_DECAY)
    t = torch.arange(x.shape[-1], dtype=torch.float64, device=x.device)
    logs = torch.log(x.to(torch.float64)) - t * c  # log 0 = -inf
    return torch.exp(t * c + torch.cummax(logs, -1).values).to(x.dtype)


def _lld(waves: torch.Tensor, preamble=None, pitch=None) -> torch.Tensor:
    """(B, T, 52) emobase tracks and deltas of padded waveforms (B, L) f32;
    ``preamble`` / ``pitch`` as already computed by the caller."""
    frames, spec = preamble if preamble is not None else FN.lld_stft_preamble(waves)
    tabs = _tables(waves.device)
    intensity = torch.sqrt(FN.static_mean(frames ** 2) + _EPS)
    loud = 10.0 * torch.log10(spec.sum(-1) + _EPS)
    sign = torch.sign(frames)
    zcr = FN.static_mean((sign[..., 1:] != sign[..., :-1]).to(torch.float32))
    f0_log, voiced, vprob = pitch if pitch is not None else EG.yin_pitch(frames)
    f0_hz = torch.where(voiced > 0.5, torch.exp2(f0_log / 12.0), 0.0)
    mfcc = (10.0 * torch.log10(spec @ tabs["mel_fb"] + _EPS)) @ tabs["dct"]  # (B, T, 12)
    band_e = 10.0 * torch.log10(spec @ tabs["bands"] + _EPS)
    base = torch.cat([torch.stack([intensity, loud, zcr, vprob, f0_hz, f0_envelope(f0_hz)],
                                  -1), mfcc, band_e], -1)  # (B, T, 26)
    delta = torch.nn.functional.pad(base[:, 1:] - base[:, :-1], (0, 0, 1, 0))
    return torch.cat([base, delta], -1)


def _reduce(tracks: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, t_pad, 52) padded tracks and valid counts (B,) -> (B, 988)."""
    t_pad = tracks.shape[1]
    t = t.to(torch.int32)
    m = FN.frame_mask(t_pad, t)[:, None]  # (B, 1, T)
    tc = t[:, None]
    x = tracks.transpose(1, 2)  # (B, 52, T)
    mx, mn = FN.masked_max(x, m), FN.masked_min(x, m)
    mean, std, skew, kurt = FN.masked_moments(x, m)
    slope, offset, err_q = FN.masked_linreg(x, m, tc)
    s = FN.masked_sort(x, m)
    q1, q2, q3 = (FN.percentile_sorted(s, tc, q) for q in (25.0, 50.0, 75.0))
    funcs = torch.stack([
        mx, mn, mx - mn, FN.masked_argmax_rel(x, m, tc), FN.masked_argmin_rel(x, m, tc),
        mean, FN.masked_mean(x.abs(), m), slope, offset, err_q, std, skew, kurt,
        q1, q2, q3, q2 - q1, q3 - q2, q3 - q1], -1)  # (B, 52, 19)
    return funcs.reshape(funcs.shape[0], -1).to(torch.float32)


def _emobase_batch(W: torch.Tensor, ts: torch.Tensor) -> torch.Tensor:
    """(B, 988) of a staged chunk."""
    return _reduce(_lld(F.pcm_to_float(W)), ts)


def functionals_chunk(W: torch.Tensor, ts: torch.Tensor, ns: torch.Tensor,
                      gemaps: bool = True, emobase: bool = True):
    """(gemaps (B, 88) or None, emobase (B, 988) or None) of a staged chunk
    from one STFT preamble and one YIN pitch: the same functions as the two
    batch paths, each computed once."""
    waves = F.pcm_to_float(W)
    preamble = FN.lld_stft_preamble(waves)
    pitch = EG.yin_pitch(preamble[0])
    g = EG._reduce(EG._lld(waves, preamble, pitch), ts, ns) if gemaps else None
    e = _reduce(_lld(waves, preamble, pitch), ts) if emobase else None
    return g, e


def emobase_functionals_batch(waveforms: dict[str, np.ndarray], quantum: int = 8000,
                              batch_size: int = 64, device="cuda") -> dict[str, np.ndarray]:
    """Featurize a corpus to (988,) vectors on ``device``, bucketed by length."""
    out = EG.corpus_vectors(waveforms, quantum, batch_size, device,
                             lambda W, ts, ns: (_emobase_batch(W, ts),))
    return out[0] if out else {}


def emobase_functionals(wave: np.ndarray, device="cuda") -> np.ndarray:
    """(n_samples,) float32 waveform -> its (988,) vector on ``device``: the
    batch entry's row for one utterance."""
    return emobase_functionals_batch({"_": np.asarray(wave, np.float32)}, device=device)["_"]


def combined_functionals_batch(waveforms: dict[str, np.ndarray], quantum: int = 8000,
                               batch_size: int = 64, device="cuda"
                               ) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """(gemaps, emobase) of a corpus from one upload of each chunk and one
    preamble and pitch a chunk (:func:`functionals_chunk`): the same vectors
    as the separate batch paths."""
    out = EG.corpus_vectors(waveforms, quantum, batch_size, device, functionals_chunk)
    return (out[0], out[1]) if out else ({}, {})
