"""Per-speaker feature normalization.

Counterpart of ``sept_tpu/data/normalize.py``, copied.  The reference's
rules (preprocess_adversary_data.py:356-390):

- statistics (mean/std/min/max per feature bin) are accumulated over every
  *written* (unpadded) window's frames per speaker: overlapping window rows
  count multiple times;
- ``znorm``:   (x - mean) / (std + 1e-5)
- ``min_max``: (x - min) / (max - min) scaled to [-1, 1]
- normalization is applied to EVERY split including test;
- 88-dim global (eGeMAPS) features are z-normed per speaker over the
  speaker's utterances.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SpeakerStats", "accumulate_stats", "apply_norm", "apply_global_norm"]


@dataclasses.dataclass
class SpeakerStats:
    mean: np.ndarray
    std: np.ndarray
    min: np.ndarray
    max: np.ndarray

    @classmethod
    def from_frames(cls, frames: np.ndarray) -> "SpeakerStats":
        """frames: (N, D) stacked feature rows for one speaker."""
        return cls(
            mean=np.nanmean(frames, axis=0),
            std=np.nanstd(frames, axis=0),
            min=np.nanmin(frames, axis=0),
            max=np.nanmax(frames, axis=0),
        )


def accumulate_stats(frame_lists: dict[object, list[np.ndarray]]) -> dict:
    """{speaker_id: [rows...]} -> {speaker_id: SpeakerStats}."""
    return {
        spk: SpeakerStats.from_frames(np.concatenate([np.atleast_2d(f) for f in rows]))
        for spk, rows in frame_lists.items()
    }


def apply_norm(data: np.ndarray, stats: SpeakerStats, norm: str = "znorm") -> np.ndarray:
    """Normalize (.., D) features with one speaker's stats."""
    if norm == "znorm":
        return (data - stats.mean) / (stats.std + 1e-5)
    if norm == "min_max":
        out = (data - stats.min) / (stats.max - stats.min)
        return out * 2.0 - 1.0
    raise ValueError(f"unknown norm: {norm!r}")


def apply_global_norm(global_data: np.ndarray, stats: SpeakerStats) -> np.ndarray:
    """Z-norm the 88-dim global features (preprocess_adversary_data.py:390)."""
    return (global_data - stats.mean) / (stats.std + 1e-5)
