"""Host data of the port (corpora, walkers, folds, windowing, normalization,
augmentation, stores, the synthetic corpus), data staging, on-device ingest
and corpus featurization.

The exported names resolve on first access (``__getattr__``): the ops
import ``data.prep``, and ``data.featurize`` imports the ops, so an eager
import here would run in a circle."""

import importlib

_HOMES = {
    "balance_classes": "augment",
    "combine_folds": "combine",
    "combine_splits": "combine",
    "EMO_LABELS": "corpora",
    "GENDER_LABELS": "corpora",
    "Utterance": "corpora",
    "parse_crema_d_filename": "corpora",
    "parse_iemocap_evaluation": "corpora",
    "parse_msp_improv_filename": "corpora",
    "featurize_corpus": "featurize",
    "SpeakerStats": "normalize",
    "accumulate_stats": "normalize",
    "apply_norm": "normalize",
    "FoldData": "pipeline",
    "SplitArrays": "pipeline",
    "assemble_fold": "pipeline",
    "batch_iterator": "pipeline",
    "SPEAKER_UNIVERSE": "splits",
    "FoldPlan": "splits",
    "plan_folds": "splits",
    "speaker_ids_for": "splits",
    "SyntheticCorpus": "synthetic",
    "make_corpus": "synthetic",
    "make_hard_corpus": "synthetic",
    "num_windows": "windowing",
    "pad_to": "windowing",
    "window_utterance": "windowing",
}

__all__ = sorted(_HOMES)


def __getattr__(name):
    home = _HOMES.get(name)
    if home is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{home}"), name)


def __dir__():
    return sorted(set(globals()) | set(_HOMES))
