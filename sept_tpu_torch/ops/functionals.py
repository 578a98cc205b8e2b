"""Host-side length bucketing of a corpus for batched featurization (numpy).

Counterpart of the bucketing half of ``sept_tpu/ops/functionals.py``
(``n_frames``, ``bucket_indices``, ``chunked_wave_batches``), kept here so
the port imports nothing of the JAX package.  The masked reducers and the
functional LLD preamble come with the global-feature slice.
"""

from __future__ import annotations

import numpy as np

from sept_tpu_torch.data.prep import pow2_rows

__all__ = ["NFFT", "HOP", "n_frames", "bucket_indices", "chunked_wave_batches"]

# the functional extractors' frame grid: 50 ms Hann frames, 10 ms hop, no
# centering (openSMILE's default at 16 kHz)
NFFT = 800
HOP = 160


def n_frames(n_samples: int, nfft: int = NFFT, hop: int = HOP) -> int:
    """Frames of the uncentered functional grid (at least 1)."""
    return max(1, 1 + (n_samples - nfft) // hop)


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
