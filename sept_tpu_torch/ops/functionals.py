"""Masked per-track functional statistics over padded time, and the length
bucketing of a corpus for batched featurization.

Counterpart of ``sept_tpu/ops/functionals.py``, kept here so the port
imports nothing of the JAX package.  Every reducer is a closed-form torch
expression over a padded time axis with an explicit valid-frame count, so
a whole bucket of utterances reduces in a handful of batched launches: the
JAX package ``vmap``s one utterance's program; here the batch is a leading
axis of every tensor.

The reducers take ``x`` with time as the LAST axis (tracks and the batch
on leading axes), a boolean ``mask`` broadcastable to x, and the valid
count ``t`` (a tensor broadcastable to ``x.shape[:-1]``).  Percentiles
reproduce np.percentile's linear interpolation; std, skewness and kurtosis
are population moments (numpy's defaults).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sept_tpu_torch.data.prep import pow2_rows
from sept_tpu_torch.ops import frontend as F

__all__ = [
    "NFFT",
    "HOP",
    "NFREQ",
    "lld_stft_preamble",
    "static_mean",
    "n_frames",
    "bucket_indices",
    "chunked_wave_batches",
    "pow2_rows",
    "frame_mask",
    "masked_mean",
    "masked_std",
    "masked_sort",
    "percentile_sorted",
    "masked_min",
    "masked_max",
    "masked_argmax_rel",
    "masked_argmin_rel",
    "masked_moments",
    "masked_linreg",
    "run_stats",
    "diff_stats",
    "compact_order",
]

_BIG = 3.0e38  # fill of masked-out cells (finite: keeps sorts NaN-free)

# the frame grid of both functional extractors (eGeMAPS and emobase): 50 ms
# Hann frames, 10 ms hop, no centering (openSMILE's default at 16 kHz)
NFFT = 800
HOP = 160
NFREQ = NFFT // 2 + 1


def n_frames(n_samples: int, nfft: int = NFFT, hop: int = HOP) -> int:
    """Frames of the uncentered functional grid (at least 1)."""
    return max(1, 1 + (n_samples - nfft) // hop)


@functools.lru_cache(maxsize=None)
def _preamble_tables(nfft: int, device: torch.device):
    """(Hann window, cos, sin) f32 tables, copied to ``device`` once."""
    return tuple(torch.tensor(a, device=device)
                 for a in (F.hann_window(nfft), *F.rdft_matrices(nfft)))


def lld_stft_preamble(waves: torch.Tensor, nfft: int = NFFT, hop: int = HOP):
    """(frames, power spectrum) of padded waveforms (B, L) on the shared
    grid: uncentered framing, Hann window, the real DFT as two f32 GEMMs
    against the cos/sin tables, |.|^2.  Returns the raw (unwindowed) frames
    (B, T, nfft), which the pitch, intensity and ZCR tracks read, beside the
    (B, T, nfft // 2 + 1) power."""
    frames = waves.unfold(-1, nfft, hop)
    window, cos_m, sin_m = _preamble_tables(nfft, waves.device)
    framed = frames * window
    re = framed @ cos_m
    im = framed @ sin_m
    return frames, re * re + im * im


def static_mean(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Mean over a fixed-size axis as XLA computes ``jnp.mean``: the sum
    times the f32 reciprocal of the count, not a division.  Where the sums
    are integers (a zero-crossing count) two frames' values tie exactly and
    this rounding, the JAX package's, decides which one an argmax picks."""
    return x.sum(dim, keepdim=keepdim) * float(np.float32(1.0 / x.shape[dim]))


def bucket_indices(lengths, quantum: int = 8000,
                   geometric: bool = True) -> dict[int, list[int]]:
    """Item indices grouped by padded length: geometric buckets
    (quantum * 2^k) or linear ones (multiples of quantum)."""
    out: dict[int, list[int]] = {}
    for i, n in enumerate(lengths):
        if geometric:
            b = quantum
            while b < n:
                b *= 2
        else:
            b = ((n + quantum - 1) // quantum) * quantum
        out.setdefault(b, []).append(i)
    return out


def frame_mask(t_pad: int, t: torch.Tensor) -> torch.Tensor:
    """(..., t_pad) bool mask of the valid frames of counts ``t`` (...)."""
    t = torch.as_tensor(t)
    return torch.arange(t_pad, device=t.device) < t[..., None]


def _count(mask):
    return torch.clamp(mask.sum(-1), min=1)


def masked_mean(x, mask):
    m = mask.to(x.dtype)
    return (x * m).sum(-1) / _count(mask)


def masked_std(x, mask):
    m = mask.to(x.dtype)
    mu = masked_mean(x, mask)
    var = (m * (x - mu[..., None]) ** 2).sum(-1) / _count(mask)
    return torch.sqrt(torch.clamp(var, min=0.0))


def masked_sort(x, mask):
    """Ascending sort with the masked-out cells pushed past the valid ones."""
    return torch.sort(torch.where(mask, x, _BIG), -1).values


def percentile_sorted(s, t, q: float):
    """np.percentile(x[:t], q) from an ascending masked sort ``s``: linear
    interpolation at position q/100 * (t - 1), numpy's default method."""
    t = torch.as_tensor(t, device=s.device)
    pos = (q / 100.0) * (t.to(torch.float32) - 1.0)
    lo = torch.clamp(torch.floor(pos).to(torch.long), 0, s.shape[-1] - 1)
    hi = torch.clamp(lo + 1, 0, s.shape[-1] - 1)
    frac = (pos - lo.to(torch.float32)).to(s.dtype)
    lo = torch.broadcast_to(lo, s.shape[:-1])[..., None]
    hi = torch.broadcast_to(hi, s.shape[:-1])[..., None]
    a = torch.gather(s, -1, lo)[..., 0]
    b = torch.gather(s, -1, hi)[..., 0]
    # t == 1: pos == 0 and a == b, exact either way
    return a * (1.0 - frac) + b * frac


def masked_min(x, mask):
    return torch.where(mask, x, _BIG).amin(-1)


def masked_max(x, mask):
    return torch.where(mask, x, -_BIG).amax(-1)


def _rel(idx, t):
    t = torch.as_tensor(t, device=idx.device)
    return idx.to(torch.float32) / torch.clamp(t, min=1).to(torch.float32)


def masked_argmax_rel(x, mask, t):
    """Relative position (in [0, 1)) of the first masked maximum."""
    return _rel(torch.argmax(torch.where(mask, x, -_BIG), -1), t)


def masked_argmin_rel(x, mask, t):
    """Relative position of the first masked minimum."""
    return _rel(torch.argmin(torch.where(mask, x, _BIG), -1), t)


def masked_moments(x, mask, eps: float = 1e-6):
    """(mean, std, skewness, excess kurtosis), population moments."""
    m = mask.to(x.dtype)
    n = _count(mask).to(x.dtype)
    mu = (x * m).sum(-1) / n
    d = (x - mu[..., None]) * m
    std = torch.sqrt(torch.clamp((d ** 2).sum(-1) / n, min=0.0))
    m3 = (d ** 3).sum(-1) / n
    m4 = (d ** 4).sum(-1) / n
    safe = torch.clamp(std, min=eps)
    skew = torch.where(std > eps, m3 / safe ** 3, 0.0)
    kurt = torch.where(std > eps, m4 / safe ** 4 - 3.0, 0.0)
    return mu, std, skew, kurt


def masked_linreg(x, mask, t):
    """(slope, offset, mean squared residual) of x against the frame index
    over the valid frames (openSMILE's linregc1 / linregc2 / linregerrQ).
    ``t`` is accepted for the JAX signature; the mask gives the count."""
    i = torch.arange(x.shape[-1], dtype=torch.float32, device=x.device)
    m = mask.to(x.dtype)
    n = _count(mask).to(x.dtype)
    mi = (i * m).sum(-1) / n
    mx = (x * m).sum(-1) / n
    di = (i - mi[..., None]) * m
    cov = (di * x).sum(-1)
    var = (di ** 2).sum(-1)
    slope = torch.where(var > 0, cov / torch.clamp(var, min=1e-20), 0.0)
    offset = mx - slope * mi
    resid = (x - slope[..., None] * i - offset[..., None]) * m
    return slope, offset, (resid ** 2).sum(-1) / n


def run_stats(flag, mask):
    """(mean run length, run count) of the True runs of ``flag`` within
    ``mask``: total True frames over the number of runs, a run starting at
    any True frame whose predecessor is False."""
    v = flag & mask
    prev = torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], -1)
    n_runs = (v & ~prev).sum(-1)
    total = v.sum(-1)
    mean_len = torch.where(n_runs > 0,
                           total.to(torch.float32) / torch.clamp(n_runs, min=1), 0.0)
    return mean_len, n_runs


def compact_order(select, t_pad: int):
    """Stable permutation putting the selected indices first, in order: a
    boolean-index gather of the selected frames (e.g. the voiced ones) as a
    fixed-shape permutation."""
    i = torch.arange(t_pad, device=select.device)
    return torch.argsort(torch.where(select, i, t_pad + i), dim=-1)  # distinct keys


def diff_stats(x, n_valid):
    """Over d = diff(x[:n_valid]): (mean rise, mean fall, mean |d|, std |d|);
    rise / fall average the strictly positive / negative diffs (0 where
    there are none), the |d| statistics are population moments over the
    n_valid - 1 diffs (0 below 2 valid elements)."""
    n_valid = torch.as_tensor(n_valid, device=x.device)
    d = x[..., 1:] - x[..., :-1]
    dm = torch.arange(d.shape[-1], device=x.device) < (n_valid[..., None] - 1)

    def signed_mean(sel):
        cnt = sel.sum(-1)
        return torch.where(cnt > 0, (d * sel).sum(-1) / torch.clamp(cnt, min=1), 0.0)

    rise, fall = signed_mean(dm & (d > 0)), signed_mean(dm & (d < 0))
    ad = d.abs()
    n_d = dm.sum(-1)
    has = n_d > 0
    mu = torch.where(has, (ad * dm).sum(-1) / torch.clamp(n_d, min=1), 0.0)
    var = torch.where(has, (dm * (ad - mu[..., None]) ** 2).sum(-1)
                      / torch.clamp(n_d, min=1), 0.0)
    return rise, fall, mu, torch.sqrt(torch.clamp(var, min=0.0))


def chunked_wave_batches(waveforms, quantum, batch_size, n_frames_fn):
    """Yield ``(utt_ids, W, ts, ns)`` zero-padded host chunks.

    Buckets by padded length, cuts each bucket into chunks of at most
    ``batch_size`` rows rounded up to a power of two, and reports per-row
    frame counts ``ts`` (``n_frames_fn`` of the length) and sample counts
    ``ns``.  Padded rows carry counts 1 and are dropped by the caller.

    If every waveform is int16 PCM the chunks stay int16 (half the
    host -> device bytes; the device side normalizes exactly with
    ``ops.frontend.pcm_to_float``).  Mixed dtypes stage as float32, with
    int16 rows normalized here.
    """
    utt_ids = list(waveforms)
    lengths = [len(waveforms[u]) for u in utt_ids]
    dtype = (np.int16
             if utt_ids and all(waveforms[u].dtype == np.int16 for u in utt_ids)
             else np.float32)
    for bucket_len, idxs in sorted(bucket_indices(lengths, quantum).items()):
        for lo in range(0, len(idxs), batch_size):
            chunk = idxs[lo: lo + batch_size]
            rows = pow2_rows(len(chunk), batch_size)
            W = np.zeros((rows, bucket_len), dtype)
            ts = np.ones(rows, np.int32)
            ns = np.ones(rows, np.int32)
            for row, i in enumerate(chunk):
                w = waveforms[utt_ids[i]]
                if w.dtype == np.int16 and dtype == np.float32:
                    w = w.astype(np.float32) * np.float32(1.0 / 32768.0)
                W[row, : len(w)] = w
                ts[row] = n_frames_fn(len(w))
                ns[row] = len(w)
            yield [utt_ids[i] for i in chunk], W, ts, ns
