"""The fold's host loop and its pieces: early stopping, combine-mode
speaker weights, the training and validation passes over host batches, the
sliding-window test vote, the fold's result and :func:`fit`.

Counterpart of ``sept_tpu/train/loop.py``.  :func:`fit` is the library's
host fold driver: any ``step_fn`` (``step(state, batch[, mask=])``, the
port's :mod:`sept_tpu_torch.train.steps`), one step a host batch of
:func:`sept_tpu_torch.data.pipeline.batch_iterator`, which shuffles with its
own ``np.random.default_rng(cfg.seed)`` (so its batch order is the JAX
package's ``fit``'s) and pads the last batch with copies of row 0 at weight
0 that go through train-mode BatchNorm, as in the JAX package.  Each batch
is copied to the state's device, ``spec`` from channels-last (B, T, D, 1)
to (B, 1, T, D).  The epoch's bookkeeping (best by validation accuracy,
early stopping, plateau) is the device loop's
(:func:`sept_tpu_torch.train.device_loop._run_epoch_loop`), shared.  The
CLIs train through the device loop on both devices: where the JAX package
takes this loop on the CPU because a scanned epoch compiles slowly there,
eager PyTorch has nothing to avoid.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from sept_tpu_torch.data.pipeline import SplitArrays, batch_iterator
from sept_tpu_torch.device import resolve_device
from sept_tpu_torch.eval import metrics as M
from sept_tpu_torch.eval.sliding import make_sliding_vote_fn, vote_split
from sept_tpu_torch.train.config import ExperimentConfig
from sept_tpu_torch.train.steps import weighted_ce
from sept_tpu_torch.utils.profiling import trace

__all__ = ["EarlyStopping", "speaker_weights", "run_train_epoch", "run_eval_epoch", "run_test",
           "fit", "FitResult", "first_head"]


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


def _row_weights(speaker_ids, datasets, weights: dict[str, float]) -> np.ndarray:
    """Each row's combine-mode loss weight ``weights["{speaker}_{dataset}"]``
    (1 for a missing key), float32."""
    return np.array([weights.get(f"{s}_{d}", 1.0) for s, d in zip(speaker_ids, datasets)],
                    dtype=np.float32)


def _apply_speaker_weights(batch: dict, weights: Optional[dict[str, float]]) -> dict:
    """The batch with its ``weight`` mask multiplied by its rows' speaker
    weights."""
    if weights is None:
        return batch
    return {**batch, "weight": batch["weight"] * _row_weights(batch["speaker_ids"],
                                                              batch["datasets"], weights)}


def _device_batch(batch: dict, device, use_global: bool = False) -> dict:
    """A host batch on ``device`` as the port's steps take it: ``spec`` (B,
    1, T, D) float32 contiguous, labels int64, ``weight`` float32, and
    ``global`` (B, 88) only with ``use_global``; ``speaker_ids`` and
    ``datasets`` stay on the host."""
    out = {"spec": torch.as_tensor(batch["spec"][..., 0], dtype=torch.float32,
                                   device=device)[:, None],
           "labels_emo": torch.as_tensor(batch["labels_emo"], dtype=torch.long, device=device),
           "labels_gen": torch.as_tensor(batch["labels_gen"], dtype=torch.long, device=device),
           "weight": torch.as_tensor(batch["weight"], dtype=torch.float32, device=device)}
    if use_global:
        out["global"] = torch.as_tensor(batch["global"], dtype=torch.float32, device=device)
    return out


def _label_key(cfg: ExperimentConfig, label_key: Optional[str]) -> str:
    return label_key or ("labels_gen" if cfg.pred == "gender" else "labels_emo")


def _pass_metrics(losses: list, preds, truth: list, valid: list) -> dict:
    """Mean of the per-batch losses, and accuracy and UAR over the real
    rows, read from the device once."""
    valid = np.concatenate(valid)
    preds = torch.cat(preds).cpu().numpy()[valid]
    truth = np.concatenate(truth)[valid]
    return {"loss": float(np.mean(torch.stack(losses).cpu().numpy().tolist())),
            "acc": M.accuracy(truth, preds), "uar": M.uar(truth, preds),
            "conf": M.confusion(truth, preds)}


def run_train_epoch(step_fn: Callable, state, split: SplitArrays, cfg: ExperimentConfig,
                    rng: np.random.Generator, spk_weights: Optional[dict] = None, mask=None,
                    label_key: Optional[str] = None):
    """One training pass over ``split`` in ``batch_iterator``'s shuffle from
    ``rng``, one ``step_fn(state, batch)`` a batch (``step_fn(state, batch,
    mask=mask)`` with a suppression ``mask`` (win_len, n_feats)) on the
    state's device; combine-mode ``spk_weights`` scale each batch's weight
    mask.  The steps' losses and predictions stay on the device until the
    epoch ends.  Returns (state, {'loss', 'acc', 'uar', 'conf'})."""
    dev = state.generator.device
    key = _label_key(cfg, label_key)
    mask_kw = {} if mask is None else {
        "mask": torch.as_tensor(mask, dtype=torch.float32, device=dev)}
    losses, preds, truth, valid = [], [], [], []
    for batch in batch_iterator(split, cfg.batch_size, rng, shuffle=True):
        batch = _apply_speaker_weights(batch, spk_weights)
        state, m = step_fn(state, _device_batch(batch, dev, cfg.global_feature), **mask_kw)
        losses.append(m["loss"])
        preds.append(m["preds"])
        truth.append(batch[key])
        valid.append(batch["weight"] > 0)
    return state, _pass_metrics(losses, preds, truth, valid)


def run_eval_epoch(logits_fn: Callable, split: SplitArrays, cfg: ExperimentConfig,
                   label_key: Optional[str] = None, spk_weights: Optional[dict] = None,
                   device="cuda") -> dict:
    """Validation pass over ``split`` in order, ``cfg.batch_size`` windows a
    batch, the last padded at weight 0.  ``logits_fn(spec (B, 1, T, D)[, g
    (B, 88)])`` is an eval forward on ``device``
    (:func:`sept_tpu_torch.train.steps.make_eval_logits_fn`; a tuple's first
    element is taken), given the batch's global vectors with
    ``cfg.global_feature``.  The loss is the mean of per-batch weighted CEs
    over each batch's real rows: combine-mode ``spk_weights`` scale the
    numerator only, as the reference's validation does.  Returns {'loss',
    'acc', 'uar'}."""
    dev = resolve_device(device)
    key = _label_key(cfg, label_key)
    losses, preds, truth, valid = [], [], [], []
    for batch in batch_iterator(split, cfg.batch_size, np.random.default_rng(0), shuffle=False):
        batch = _apply_speaker_weights(batch, spk_weights)
        db = _device_batch(batch, dev, cfg.global_feature)
        g = (db["global"],) if cfg.global_feature else ()
        logits = first_head(logits_fn(db["spec"], *g))
        losses.append(weighted_ce(logits, db[key], db["weight"]))
        preds.append(logits.argmax(-1))
        truth.append(batch[key])
        valid.append(batch["weight"] > 0)
    out = _pass_metrics(losses, preds, truth, valid)
    del out["conf"]
    return out


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


def fit(state, step_fn: Callable, logits_fn: Callable, train_split: SplitArrays,
        val_split: SplitArrays, test_split: SplitArrays, cfg: ExperimentConfig,
        spk_weights: Optional[dict] = None, mask=None, verbose: bool = True,
        profile_dir: Optional[str] = None, epoch_callback=None) -> FitResult:
    """One fold through the host loop on the state's device
    (``state.generator.device``): per epoch :func:`run_train_epoch` of
    ``step_fn``, :func:`run_eval_epoch` and :func:`run_test` of the eval
    forward ``logits_fn``, and the device loop's decisions
    (:func:`sept_tpu_torch.train.device_loop._run_epoch_loop`, which draws
    no shuffle here: ``batch_iterator`` shuffles).  ``mask``: the cloak's
    suppression mask, passed to each step as ``mask=``.  ``profile_dir``
    wraps the first training epoch in :func:`sept_tpu_torch.utils.trace`.
    ``epoch_callback(state) -> dict`` adds per-epoch observables to the
    history.  No mid-fold resume: the shuffle stream lives in this loop."""
    from sept_tpu_torch.train.device_loop import _run_epoch_loop

    dev = resolve_device(state.generator.device)
    rng = np.random.default_rng(cfg.seed)

    def train_epoch(st, epoch, order):  # order is None: batch_iterator shuffles
        with trace(profile_dir, enabled=epoch == 0):
            return run_train_epoch(step_fn, st, train_split, cfg, rng, spk_weights, mask)

    return _run_epoch_loop(
        state, cfg, train_epoch=train_epoch,
        val_epoch=lambda st: run_eval_epoch(logits_fn, val_split, cfg, spk_weights=spk_weights,
                                            device=dev),
        test_epoch=lambda st: run_test(logits_fn, test_split, cfg, device=dev),
        m_total=len(train_split), needs_order=False, verbose=verbose,
        epoch_callback=epoch_callback)
