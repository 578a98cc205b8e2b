"""Speaker-disjoint k-fold split planner.

Counterpart of ``sept_tpu/data/splits.py``, copied, with scikit-learn's
``KFold`` restated in numpy (:func:`kfold_splits`): the port's machine has
no scikit-learn.  The reference's rules (adversary_data_preprocess.py:9-69):

- speaker universes: IEMOCAP 10 session-halves, CREMA-D ids 1001..1091,
  MSP-IMPROV 12 speakers;
- ``KFold(n_splits=5)`` over the speaker array, shuffled with seed 8 for
  CREMA-D, unshuffled otherwise;
- per fold, the non-test speakers split ~40% baseline / ~40% adversary /
  20% test: adversary pool = a window of round(len/2) speakers starting at
  ``len(test_array)`` (the fold-index offset quirk of :52, reproduced so
  that folds match the reference), baseline = the rest;
- 20% of each pool (rounded, computed from the *baseline* pool size for both,
  :56-57, reproduced) carved out as validation from the FRONT of the pool.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = ["FoldPlan", "SPEAKER_UNIVERSE", "kfold_splits", "plan_folds", "speaker_ids_for"]

# adversary_data_preprocess.py:9-11
SPEAKER_UNIVERSE = {
    "msp-improv": np.arange(0, 12, 1),
    "crema-d": np.arange(1001, 1092, 1),
    "iemocap": np.arange(0, 10, 1),
}

# index -> concrete speaker id (preprocess_adversary_data.py:235,312)
IEMOCAP_SPEAKERS = [
    "Ses01F", "Ses01M", "Ses02F", "Ses02M", "Ses03F",
    "Ses03M", "Ses04F", "Ses04M", "Ses05F", "Ses05M",
]
MSP_IMPROV_SPEAKERS = [
    "M01", "F01", "M02", "F02", "M03", "F03",
    "M04", "F04", "M05", "F05", "M06", "F06",
]


def kfold_splits(n: int, n_splits: int, seed: Optional[int] = None):
    """scikit-learn's ``KFold(n_splits, shuffle=seed is not None,
    random_state=seed).split`` of ``n`` samples, in numpy: yields
    (train_index, test_index), both ascending.  Test blocks are contiguous
    runs of the (shuffled) order: the first ``n % n_splits`` hold
    ``n // n_splits + 1`` samples, the rest ``n // n_splits``.  Shuffling is
    ``np.random.RandomState(seed).shuffle`` of ``arange(n)``, in place, as
    scikit-learn's ``check_random_state(seed).shuffle`` does."""
    if not 2 <= n_splits <= n:
        raise ValueError(f"n_splits={n_splits} must be in [2, {n}] for {n} samples")
    order = np.arange(n)
    if seed is not None:
        np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    start = 0
    for size in sizes:
        test = np.zeros(n, dtype=bool)
        test[order[start:start + size]] = True
        start += size
        yield np.flatnonzero(~test), np.flatnonzero(test)


@dataclasses.dataclass(frozen=True)
class FoldPlan:
    """Speaker index assignments for one cross-validation fold."""

    fold: int  # 1-based, matching the reference's fold1..fold5 naming
    train: tuple
    validation: tuple
    adv_train: tuple
    adv_validation: tuple
    test: tuple

    def all_speakers(self):
        return (
            set(self.train)
            | set(self.validation)
            | set(self.adv_train)
            | set(self.adv_validation)
            | set(self.test)
        )


def plan_folds(dataset: str, n_folds: int = 5, validate: bool = True) -> list[FoldPlan]:
    """Compute the 5 speaker-disjoint folds for a corpus.

    Returns raw speaker *ids* (ints for crema-d, indices for others, exactly
    as the reference passes them on the preprocess CLI,
    adversary_data_preprocess.py:85-101).
    """
    speaker_id_arr = SPEAKER_UNIVERSE[dataset]
    seed = 8 if dataset == "crema-d" else None

    plans = []
    test_array: list[np.ndarray] = []  # grows across folds; len used as offset (:52)
    for fold_idx, (other_index, test_index) in enumerate(
        kfold_splits(len(speaker_id_arr), n_folds, seed)):
        tmp_arr = speaker_id_arr[other_index]
        adversary_len = int(np.round(len(tmp_arr) * 0.5))

        # reference quirk :52: the adversary window starts at len(test_array),
        # i.e. at the current fold index — reproduced for split parity.
        start = len(test_array)
        adversary_arr = tmp_arr[start : start + adversary_len]
        baseline_arr = [t for t in tmp_arr if t not in adversary_arr]

        if validate:
            # both validate lengths derive from the BASELINE pool size (:56-57)
            val_len = int(np.round(len(baseline_arr) * 0.2))
            baseline_train = baseline_arr[val_len:]
            baseline_val = [t for t in baseline_arr if t not in baseline_train]
            adversary_train = adversary_arr[val_len:]
            adversary_val = [t for t in adversary_arr if t not in adversary_train]
        else:
            baseline_train, baseline_val = baseline_arr, []
            adversary_train, adversary_val = list(adversary_arr), []

        test_array.append(speaker_id_arr[test_index])
        plans.append(
            FoldPlan(
                fold=fold_idx + 1,
                train=tuple(int(t) for t in baseline_train),
                validation=tuple(int(t) for t in baseline_val),
                adv_train=tuple(int(t) for t in adversary_train),
                adv_validation=tuple(int(t) for t in adversary_val),
                test=tuple(int(t) for t in speaker_id_arr[test_index]),
            )
        )
    return plans


def speaker_ids_for(dataset: str, indices: Sequence[int]) -> list:
    """Map split indices to concrete speaker ids per corpus
    (preprocess_adversary_data.py:237-241, :278-282, :315-319)."""
    if dataset == "iemocap":
        return [IEMOCAP_SPEAKERS[i] for i in indices]
    if dataset == "msp-improv":
        return [MSP_IMPROV_SPEAKERS[i] for i in indices]
    if dataset == "crema-d":
        return [int(i) for i in indices]
    raise ValueError(f"unknown dataset: {dataset!r}")
