"""Array stores of the protocol's stages.

Counterpart of ``sept_tpu/data/store.py``, copied: the same ``.npz`` keys
and the same JSON manifest, so a store, fold or manifest written by one
package is read by the other.  Features and folds are compressed ``.npz``
archives (``'<utt_id>|<feature>'`` and ``'<split>|<array>'`` keys; string
arrays stored as unicode, never pickled) and the manifest a JSON list of
utterance records, where the reference pickles nested dicts.
"""

from __future__ import annotations

import json
import os

import numpy as np

from sept_tpu_torch.data.corpora import Utterance
from sept_tpu_torch.data.pipeline import FoldData, SplitArrays

__all__ = [
    "save_feature_store",
    "load_feature_store",
    "save_fold",
    "load_fold",
    "save_manifest",
    "load_manifest",
]


def save_feature_store(path: str, store: dict[str, dict[str, np.ndarray]]) -> None:
    """{utt_id: {feat_name: array}} -> one npz with 'uttid|feat' keys."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    flat = {}
    for utt, feats in store.items():
        for name, arr in feats.items():
            flat[f"{utt}|{name}"] = np.asarray(arr)
    np.savez_compressed(path, **flat)


def load_feature_store(path: str) -> dict[str, dict[str, np.ndarray]]:
    out: dict[str, dict[str, np.ndarray]] = {}
    with np.load(path) as z:
        for key in z.files:
            utt, name = key.rsplit("|", 1)
            out.setdefault(utt, {})[name] = z[key]
    return out


def _split_to_arrays(s: SplitArrays) -> dict[str, np.ndarray]:
    return {
        "windows": s.windows,
        "labels_emo": s.labels_emo,
        "labels_gen": s.labels_gen,
        "lengths": s.lengths,
        "global_data": s.global_data,
        "speaker_ids": s.speaker_ids.astype(str),
        "datasets": s.datasets.astype(str),
        "utt_ids": s.utt_ids.astype(str),
    }


def _split_from_arrays(d) -> SplitArrays:
    return SplitArrays(
        windows=d["windows"],
        labels_emo=d["labels_emo"],
        labels_gen=d["labels_gen"],
        lengths=d["lengths"],
        global_data=d["global_data"],
        speaker_ids=d["speaker_ids"].astype(object),
        datasets=d["datasets"].astype(object),
        utt_ids=d["utt_ids"].astype(object),
    )


_SPLITS = ("training", "validation", "adv_training", "adv_validation", "test")


def save_fold(path: str, fold: FoldData) -> None:
    """One npz per fold holding all five splits."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    flat = {"fold": np.asarray(fold.fold)}
    for split in _SPLITS:
        for k, v in _split_to_arrays(fold.split(split)).items():
            flat[f"{split}|{k}"] = v
    np.savez_compressed(path, **flat)


def load_fold(path: str) -> FoldData:
    with np.load(path, allow_pickle=False) as z:
        splits = {}
        for split in _SPLITS:
            d = {k.split("|", 1)[1]: z[k] for k in z.files if k.startswith(split + "|")}
            splits[split] = _split_from_arrays(d)
        return FoldData(fold=int(z["fold"]), **splits)


def save_manifest(path: str, manifest: list[Utterance]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(
            [
                {
                    "utt_id": u.utt_id,
                    "label": u.label,
                    "gender": u.gender,
                    "speaker_id": u.speaker_id,
                    "dataset": u.dataset,
                    "path": u.path,
                }
                for u in manifest
            ],
            f,
            indent=1,
        )


def load_manifest(path: str) -> list[Utterance]:
    with open(path) as f:
        return [Utterance(**d) for d in json.load(f)]
