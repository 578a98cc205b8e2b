"""Pieces of the fold loop: early stopping, combine-mode speaker weights,
the sliding-window test vote and the fold's result.

Counterpart of ``sept_tpu/train/loop.py``'s ``EarlyStopping``,
``speaker_weights``, ``run_test`` and ``FitResult``.  The JAX package's
per-step host loop (``fit``, ``run_train_epoch``, ``run_eval_epoch``), which
it takes on the CPU where a scanned epoch compiles too slowly, makes the
same decisions as its device loop; the port has one driver, the device
loop of :mod:`sept_tpu_torch.train.device_loop`, on both devices.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from sept_tpu_torch.data.pipeline import SplitArrays
from sept_tpu_torch.device import resolve_device
from sept_tpu_torch.eval import metrics as M
from sept_tpu_torch.eval.sliding import make_sliding_vote_fn, vote_split
from sept_tpu_torch.train.config import ExperimentConfig

__all__ = ["EarlyStopping", "speaker_weights", "run_test", "FitResult", "first_head"]


class EarlyStopping:
    """Patience counter on validation loss (the reference's
    training_tools.py)."""

    def __init__(self, patience: int = 10, delta: float = 0.0):
        self.patience = patience
        self.delta = delta
        self.best: Optional[float] = None
        self.counter = 0
        self.should_stop = False

    def __call__(self, val_loss: float) -> bool:
        score = -val_loss
        if self.best is None:
            self.best = score
        elif score < self.best + self.delta:
            self.counter += 1
            if self.counter >= self.patience:
                self.should_stop = True
        else:
            self.best = score
            self.counter = 0
        return self.should_stop


def speaker_weights(split: SplitArrays) -> dict[str, float]:
    """Per-(speaker, dataset) loss weights for combine mode."""
    counts: dict[str, int] = {}
    for spk, ds in zip(split.speaker_ids, split.datasets):
        key = f"{spk}_{ds}"
        counts[key] = counts.get(key, 0) + 1
    return M.get_class_weight(counts)


def first_head(out):
    """The logits a metric tracks: the emotion head of a multitask model, a
    cloaked model's emotion logits, else the logits themselves."""
    return out[0] if isinstance(out, tuple) else out


def run_test(logits_fn: Callable, test: SplitArrays, cfg: ExperimentConfig,
             label_key: Optional[str] = None, batch_size: int = 16, device="cuda",
             group=None):
    """Sliding-window vote over whole test utterances, ``batch_size`` at a
    time; the last batch is padded with zero utterances of ``win_len``
    frames, whose results are cut.  ``logits_fn`` is an eval forward
    (:func:`sept_tpu_torch.train.steps.make_eval_logits_fn`) on ``device``;
    with ``cfg.global_feature`` it also takes each window's (88,) vector,
    its utterance's ``test.global_data`` row.  Combine mode (more than one
    corpus tag) adds a ``per_dataset`` breakdown.  ``group``: the ranks of a
    data-parallel group vote their rows of each batch
    (:func:`~sept_tpu_torch.eval.sliding.vote_split`) and return the same
    result."""
    dev = resolve_device(device)
    label_key = label_key or ("labels_gen" if cfg.pred == "gender" else "labels_emo")
    vote = make_sliding_vote_fn(lambda wins, *g: first_head(logits_fn(wins, *g)),
                                cfg.win_len, cfg.shift_len)
    probs = vote_split(vote, test, cfg.win_len, batch_size, dev, cfg.global_feature, group)
    preds = probs.argmax(-1) if len(probs) else np.zeros(0, np.int64)
    truth = getattr(test, label_key)
    return {**M.split_result(truth, preds, test.datasets, rec_key="uar"), "preds": preds,
            "truth": truth}


@dataclasses.dataclass
class FitResult:
    """``best_state`` is a :meth:`sept_tpu_torch.train.steps.TrainState.snapshot`
    (``best_state["model"]`` the best epoch's state_dict)."""

    best_state: dict
    best_epoch: int
    best_val_acc: float
    final_test_acc: float
    final_test_uar: float
    final_confusion: np.ndarray
    history: list
