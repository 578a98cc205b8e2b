"""Fold containers: a fold's five splits as stacked numpy arrays.

Counterpart of ``sept_tpu/data/pipeline.py``'s ``SplitArrays`` and
``FoldData``.  Building them from a featurized corpus (``assemble_fold``)
and the host batch iterator come with the host data (ROADMAP.md §1 item 9);
the fold drivers take the containers as they are.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SplitArrays", "FoldData"]


@dataclasses.dataclass
class SplitArrays:
    """One split's data as stacked arrays."""

    windows: np.ndarray  # (N, T, D) float32: T = win_len, or max_T for test
    labels_emo: np.ndarray  # (N,) int32
    labels_gen: np.ndarray  # (N,) int32
    lengths: np.ndarray  # (N,) int32 true frame counts (pre-padding)
    global_data: np.ndarray  # (N, 88) float32
    speaker_ids: np.ndarray  # (N,) object
    datasets: np.ndarray  # (N,) object (corpus tag, for combine mode)
    utt_ids: np.ndarray  # (N,) object

    def __len__(self) -> int:
        return len(self.windows)


@dataclasses.dataclass
class FoldData:
    fold: int
    training: SplitArrays
    validation: SplitArrays
    adv_training: SplitArrays
    adv_validation: SplitArrays
    test: SplitArrays
