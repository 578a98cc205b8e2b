"""Fold assembly: featurized corpus -> fixed-shape split arrays.

Counterpart of ``sept_tpu/data/pipeline.py``, copied.  Where the reference
pickles dicts of dicts per split, each fold is five ``SplitArrays`` of
stacked numpy arrays (training / validation / adv_training / adv_validation
/ test), ready to go to the device:

- train-family splits: (N, win_len, D) windows (stride win_len//4, zero-pad
  short utterances), per-speaker-normalized, the training split optionally
  class-balanced (augment.balance_classes);
- test split: whole utterances padded to the split's max frame count with a
  ``lengths`` array, for the sliding-window vote at eval time (the
  reference's store-whole-utterance protocol, preprocess_adversary_data.py:
  56-60).

Norm statistics follow the reference: accumulated over every *written*
(unpadded) window's rows per speaker (:26-27), then applied to all splits
including test (:373-390), each window padded before it is normalized.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from sept_tpu_torch.data import augment as aug_mod
from sept_tpu_torch.data import normalize as norm_mod
from sept_tpu_torch.data.corpora import EMO_LABELS, GENDER_LABELS, Utterance
from sept_tpu_torch.data.splits import FoldPlan, speaker_ids_for
from sept_tpu_torch.data.windowing import pad_to, window_utterance

__all__ = ["SplitArrays", "FoldData", "assemble_fold", "batch_iterator"]


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

    def split(self, name: str) -> SplitArrays:
        return getattr(self, name)


def _feature_matrix(
    features: dict[str, np.ndarray], feature_type: str, feature_len: int
) -> np.ndarray:
    """Reference feature selection: mel1 or mfcc[:40], transposed to (T, D)
    (preprocess_adversary_data.py:270,304,345)."""
    if feature_type == "mel_spec":
        return np.asarray(features["mel1"], dtype=np.float32).T
    return np.asarray(features["mfcc"], dtype=np.float32)[:40].T


def _split_of(utt: Utterance, plan_ids: dict[str, set]) -> Optional[str]:
    for name in ("test", "adv_validation", "adv_train", "validation", "train"):
        if utt.speaker_id in plan_ids[name]:
            return name
    return None


def assemble_fold(
    manifest: Sequence[Utterance],
    feature_store: dict[str, dict[str, np.ndarray]],
    plan: FoldPlan,
    speaker_map: Optional[dict[str, Sequence]] = None,
    dataset: str = "synthetic",
    feature_type: str = "mel_spec",
    feature_len: int = 128,
    win_len: int = 200,
    norm: str = "znorm",
    aug: Optional[str] = "emotion",
    seed: int = 8,
    shift: bool = True,
) -> FoldData:
    """Build one fold's five splits from a featurized corpus.

    ``speaker_map`` maps plan index groups to concrete speaker ids; by default
    uses :func:`speaker_ids_for` for the named reference corpora, or treats
    plan entries as direct speaker ids (synthetic corpora with arbitrary
    speaker tags should pass an explicit map).
    """
    if speaker_map is None:
        if dataset in ("iemocap", "crema-d", "msp-improv"):
            speaker_map = {
                name: speaker_ids_for(dataset, getattr(plan, attr))
                for name, attr in (
                    ("train", "train"),
                    ("validation", "validation"),
                    ("adv_train", "adv_train"),
                    ("adv_validation", "adv_validation"),
                    ("test", "test"),
                )
            }
        else:
            speaker_map = {
                "train": list(plan.train),
                "validation": list(plan.validation),
                "adv_train": list(plan.adv_train),
                "adv_validation": list(plan.adv_validation),
                "test": list(plan.test),
            }
    plan_ids = {k: set(v) for k, v in speaker_map.items()}

    shift_len = win_len // 4
    rows: dict[str, list] = {
        k: [] for k in ("train", "validation", "adv_train", "adv_validation", "test")
    }
    norm_frames: dict[object, list[np.ndarray]] = {}
    norm_globals: dict[object, list[np.ndarray]] = {}

    max_test_t = win_len
    for utt in manifest:
        split = _split_of(utt, plan_ids)
        if split is None or utt.utt_id not in feature_store:
            continue
        feats = feature_store[utt.utt_id]
        data = _feature_matrix(feats, feature_type, feature_len)[:, :feature_len]
        gdata = np.asarray(feats.get("gemaps", np.zeros(88)), dtype=np.float32).ravel()

        norm_frames.setdefault(utt.speaker_id, [])
        norm_globals.setdefault(utt.speaker_id, [])
        norm_globals[utt.speaker_id].append(gdata)

        if split == "test":
            # whole utterance, single entry (preprocess_adversary_data.py:56-60)
            norm_frames[utt.speaker_id].append(data)
            rows["test"].append((data, utt, gdata, len(data)))
            max_test_t = max(max_test_t, len(data))
        else:
            windows = window_utterance(data, win_len, shift_len, shift=shift)
            t = len(data)
            for w_idx in range(len(windows)):
                # stats accumulate the UNPADDED rows the reference writes
                true_rows = (
                    data[w_idx * shift_len : w_idx * shift_len + win_len]
                    if t >= win_len
                    else data
                )
                norm_frames[utt.speaker_id].append(true_rows)
                rows[split].append((windows[w_idx], utt, gdata, min(t, win_len)))

    stats = norm_mod.accumulate_stats(norm_frames)
    gstats = norm_mod.accumulate_stats(norm_globals)

    def build(split: str, pad_t: int) -> SplitArrays:
        items = rows[split]
        n = len(items)
        windows = np.zeros((n, pad_t, feature_len), dtype=np.float32)
        labels_emo = np.zeros(n, dtype=np.int32)
        labels_gen = np.zeros(n, dtype=np.int32)
        lengths = np.zeros(n, dtype=np.int32)
        gdatas = np.zeros((n, 88), dtype=np.float32)
        speakers = np.empty(n, dtype=object)
        dsets = np.empty(n, dtype=object)
        uids = np.empty(n, dtype=object)
        for i, (data, utt, gdata, t) in enumerate(items):
            # pad THEN normalize: the reference fillna(0)-pads the window
            # before per-speaker normalization, so pad rows become
            # (0 - mean)/std rather than raw zeros
            # (preprocess_adversary_data.py:29-34,373-385)
            if len(data) < pad_t:
                data = pad_to(data, pad_t)
            windows[i] = norm_mod.apply_norm(data, stats[utt.speaker_id], norm)
            labels_emo[i] = EMO_LABELS[utt.label]
            labels_gen[i] = GENDER_LABELS[utt.gender]
            lengths[i] = t
            gdatas[i] = norm_mod.apply_global_norm(gdata, gstats[utt.speaker_id])
            speakers[i] = utt.speaker_id
            dsets[i] = utt.dataset
            uids[i] = utt.utt_id
        return SplitArrays(
            windows, labels_emo, labels_gen, lengths, gdatas, speakers, dsets, uids
        )

    split_arrays = {
        "training": build("train", win_len),
        "validation": build("validation", win_len),
        "adv_training": build("adv_train", win_len),
        "adv_validation": build("adv_validation", win_len),
        "test": build("test", max_test_t),
    }

    if aug is not None:
        # the reference augments ONLY the baseline training split —
        # aug_key_list is built from training_dict and only training_dict is
        # mutated (preprocess_adversary_data.py:392-423); adv_training is
        # pickled unaugmented, so the adversary trains on the natural class
        # balance
        for key in ("training",):
            s = split_arrays[key]
            if len(s) == 0:
                continue
            rng = np.random.default_rng(seed)
            bal_on = s.labels_emo if aug == "emotion" else s.labels_gen
            extra = {
                "labels_emo": s.labels_emo,
                "labels_gen": s.labels_gen,
                "lengths": s.lengths,
                "global_data": s.global_data,
                "speaker_ids": s.speaker_ids,
                "datasets": s.datasets,
                "utt_ids": s.utt_ids,
            }
            windows, _, out = aug_mod.balance_classes(s.windows, bal_on, rng, extra=extra)
            split_arrays[key] = SplitArrays(
                windows,
                out["labels_emo"],
                out["labels_gen"],
                out["lengths"],
                out["global_data"],
                out["speaker_ids"],
                out["datasets"],
                out["utt_ids"],
            )

    return FoldData(fold=plan.fold, **split_arrays)


def batch_iterator(
    split: SplitArrays,
    batch_size: int,
    rng: np.random.Generator,
    shuffle: bool = True,
    drop_remainder: bool = False,
):
    """Yield dict batches; the final partial batch is zero-padded to
    ``batch_size`` with a ``weight`` mask (one batch shape for every step)."""
    n = len(split)
    order = rng.permutation(n) if shuffle else np.arange(n)
    for lo in range(0, n, batch_size):
        idx = order[lo : lo + batch_size]
        pad = batch_size - len(idx)
        if pad and drop_remainder:
            break
        weight = np.ones(batch_size, dtype=np.float32)
        if pad:
            weight[len(idx) :] = 0.0
            idx = np.concatenate([idx, np.zeros(pad, dtype=idx.dtype)])
        yield {
            "spec": split.windows[idx][..., None],  # (B, T, D, 1)
            "labels_emo": split.labels_emo[idx],
            "labels_gen": split.labels_gen[idx],
            "global": split.global_data[idx],
            "weight": weight,
            "speaker_ids": split.speaker_ids[idx],
            "datasets": split.datasets[idx],
        }
