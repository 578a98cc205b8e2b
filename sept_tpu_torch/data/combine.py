"""Combine mode: merge per-corpus folds into one multi-corpus fold.

Counterpart of ``sept_tpu/data/combine.py``, copied (the reference's
``combine_data()``, preprocess_adversary_data.py:86-104): per fold, the
corpora's already-normalized splits are concatenated, each item tagged by
its source corpus (the ``dataset`` key), so training can weight the loss
per (speaker, dataset) and evaluation can report the per-corpus breakdown.
Test splits store whole utterances of different max lengths per corpus;
merging zero-pads them to the common maximum.
"""

from __future__ import annotations

import numpy as np

from sept_tpu_torch.data.pipeline import FoldData, SplitArrays

__all__ = ["combine_splits", "combine_folds"]


def combine_splits(splits: list[SplitArrays]) -> SplitArrays:
    """Concatenate splits, zero-padding windows to the widest time axis."""
    splits = [s for s in splits if len(s)]
    if not splits:
        raise ValueError("no non-empty splits to combine")
    max_t = max(s.windows.shape[1] for s in splits)
    d = splits[0].windows.shape[2]

    def padded(s: SplitArrays) -> np.ndarray:
        if s.windows.shape[1] == max_t:
            return s.windows
        out = np.zeros((len(s), max_t, d), dtype=s.windows.dtype)
        out[:, : s.windows.shape[1]] = s.windows
        return out

    return SplitArrays(
        windows=np.concatenate([padded(s) for s in splits]),
        labels_emo=np.concatenate([s.labels_emo for s in splits]),
        labels_gen=np.concatenate([s.labels_gen for s in splits]),
        lengths=np.concatenate([s.lengths for s in splits]),
        global_data=np.concatenate([s.global_data for s in splits]),
        speaker_ids=np.concatenate([s.speaker_ids for s in splits]),
        datasets=np.concatenate([s.datasets for s in splits]),
        utt_ids=np.concatenate([s.utt_ids for s in splits]),
    )


def combine_folds(folds: list[FoldData]) -> FoldData:
    """Merge same-numbered folds from several corpora into one fold."""
    fold_nums = {f.fold for f in folds}
    if len(fold_nums) != 1:
        raise ValueError(f"fold numbers differ: {sorted(fold_nums)}")
    return FoldData(
        fold=folds[0].fold,
        training=combine_splits([f.training for f in folds]),
        validation=combine_splits([f.validation for f in folds]),
        adv_training=combine_splits([f.adv_training for f in folds]),
        adv_validation=combine_splits([f.adv_validation for f in folds]),
        test=combine_splits([f.test for f in folds]),
    )
