"""Device-resident fold training: whole epochs on the device, the fold's
control flow on the host.

Counterpart of ``sept_tpu/train/device_loop.py``.  A fold's splits go to
the device once (:class:`DeviceSplit`); each training epoch runs through the
port's epoch runner (:mod:`sept_tpu_torch.train.steps`), each validation
pass through :func:`make_val_pass`, each test vote through
:func:`sept_tpu_torch.train.loop.run_test`, and only per-epoch scalars come
back to the host, where :func:`_run_epoch_loop` takes the reference's
decisions: best by validation accuracy (strictly higher, after
``min(min_select_epoch, num_epochs - 2)``), early stopping on validation
loss (patience accrues only once selection opens; under SGD only with
``early_stop_with_sgd``), plateau scaling (Adam only), mid-fold
checkpoints with the shuffle stream replayed on resume.

The state is updated in place, so the best state is a snapshot
(:meth:`sept_tpu_torch.train.steps.TrainState.snapshot`), never the live
state.  Shuffles come from ``np.random.default_rng(cfg.seed)``, one
permutation of the real rows an epoch with the pad rows last, as in the JAX
package.  With ``cfg.global_feature`` each split's 88-dim ``global_data``
goes to the device beside its windows (:class:`DeviceSplit`) and to every
forward.

Data parallelism (the JAX fold loops' ``mesh``): with a ``group`` (a
:class:`~sept_tpu_torch.parallel.DataGroup`) every rank runs the fold
driver on its own device.  The splits are replicated, rank 0's state is
broadcast first, each epoch runs through the DP runners of
:mod:`sept_tpu_torch.parallel.epoch_dp` (the models should be built with
``bn_group`` for equality with one device), and the validation pass and
the test vote split each batch's rows over the ranks and all-reduce what
they return.  Every decision of the epoch loop is taken from numbers that
are the same on every rank, so no rank leaves the loop alone; rank 0 alone
prints and writes the mid-fold checkpoints.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from sept_tpu_torch.data.pipeline import SplitArrays
from sept_tpu_torch.device import resolve_device
from sept_tpu_torch.eval import metrics as M
from sept_tpu_torch.models import pooling_for
from sept_tpu_torch.parallel import (broadcast_state, is_main, make_cloak_epoch_runner_dp,
                                     make_epoch_runner_dp)
from sept_tpu_torch.train.config import ExperimentConfig
from sept_tpu_torch.train.loop import (EarlyStopping, FitResult, _row_weights, first_head,
                                      run_test)
from sept_tpu_torch.train.midfold import MidFoldCheckpoint
from sept_tpu_torch.train.optim import PlateauScheduler, set_lr_scale
from sept_tpu_torch.train.steps import (
    TrainState,
    make_cloak_epoch_runner,
    make_epoch_runner,
    weighted_ce,
    weighted_nll_sum,
)
from sept_tpu_torch.utils.logging import _jsonable

__all__ = ["DeviceSplit", "make_val_pass", "fit_device", "fit_device_cloak"]


class DeviceSplit:
    """One split's windows, labels and weights on the device, padded to a
    multiple of the batch size with copies of row 0 at weight 0.

    ``split`` is any object with ``windows`` (N, T, D), ``labels_emo``,
    ``labels_gen`` and ``global_data`` (N, 88) arrays (a
    :class:`SplitArrays`, or the JAX package's); ``globals`` is the last on
    the device, as the JAX package uploads it whether or not it is used.  The
    pad copies are excluded from loss and metrics by their weight but still
    enter train-mode BatchNorm statistics, as in the JAX package: all-zero
    rows would bias them with out-of-distribution data.
    """

    def __init__(self, split, label_key: str, batch_size: int,
                 extra_weights: Optional[np.ndarray] = None, device="cuda"):
        dev = resolve_device(device)
        n = len(split.windows)
        pad = (-n) % batch_size
        w = np.ones(n + pad, np.float32)
        w[n:] = 0.0
        if extra_weights is not None:
            w[:n] *= extra_weights

        def padded(a, dtype):
            a = np.asarray(a)
            if pad:
                a = np.concatenate([a, np.repeat(a[:1], pad, axis=0)])
            return torch.as_tensor(a, dtype=dtype, device=dev)

        self.windows = padded(split.windows, torch.float32)
        self.labels_emo = padded(split.labels_emo, torch.long)
        self.labels_gen = padded(split.labels_gen, torch.long)
        self.labels = self.labels_gen if label_key == "labels_gen" else self.labels_emo
        self.weights = torch.as_tensor(w, device=dev)
        self.globals = padded(split.global_data, torch.float32)
        self.n_real = n
        self.n_batches = (n + pad) // batch_size
        self.batch_size = batch_size


def _spk_weight_vec(split, spk_weights: Optional[dict]) -> Optional[np.ndarray]:
    """Per-row combine-mode loss weights of ``split`` (its ``speaker_ids``
    and ``datasets``), or None without ``spk_weights``."""
    if spk_weights is None:
        return None
    return _row_weights(split.speaker_ids, split.datasets, spk_weights)


def _masked_uar(truth: np.ndarray, preds: np.ndarray, valid: np.ndarray):
    t, p = truth[valid], preds[valid]
    return M.accuracy(t, p), M.uar(t, p)


def _loop_snapshot(epoch, best_val_acc, best_epoch, early, plateau, final, history):
    """Host bookkeeping -> a JSON-able dict (see train.midfold)."""
    return _jsonable({
        "epoch": epoch, "best_val_acc": best_val_acc, "best_epoch": best_epoch,
        "early_best": early.best, "early_counter": early.counter,
        "early_stop": early.should_stop,
        "plateau_best": plateau.best, "plateau_bad": plateau.bad_epochs,
        "plateau_scale": plateau.scale,
        "final": {"acc": final["acc"], "uar": final["uar"],
                  "conf": np.asarray(final["conf"]).tolist()},
        "history": history,
    })


def _loop_restore(loop, early, plateau):
    """Inverse of _loop_snapshot; returns (start_epoch, best_val_acc,
    best_epoch, final, history)."""
    early.best = loop["early_best"]
    early.counter = loop["early_counter"]
    early.should_stop = loop["early_stop"]
    plateau.best = loop["plateau_best"]
    plateau.bad_epochs = loop["plateau_bad"]
    plateau.scale = loop["plateau_scale"]
    final = {"acc": loop["final"]["acc"], "uar": loop["final"]["uar"],
             "conf": np.asarray(loop["final"]["conf"])}
    return (loop["epoch"] + 1, loop["best_val_acc"], loop["best_epoch"], final,
            loop["history"])


def make_val_pass(apply_logits: Callable, use_global: bool = False, group=None):
    """Whole-split validation pass, batch by batch, so peak activation memory
    stays bounded by the batch size.  ``apply_logits(windows (B, 1, T, D)[,
    g (B, 88)])`` is an eval forward
    (:func:`sept_tpu_torch.train.steps.make_eval_logits_fn`; a tuple's first
    element is taken), given the batch's global vectors with ``use_global``.
    Returns ``val(windows (M, T, D), labels (M,), weights (M,), n_batches,
    batch_size[, globals_ (M, 88)]) -> (loss, preds (M,))``, where the loss
    is the MEAN OF PER-BATCH MEANS (each batch's
    weighted CE over its real rows), the statistic the reference feeds to the
    plateau scheduler and early stopping; one weighted mean over the split
    would differ whenever it is not a multiple of the batch size.

    ``group``: each rank takes its rows of every batch (``batch_size``
    divisible by the world size), and one all-reduce of each batch's NLL sum
    and real-row count and of the zero-filled predictions gives every rank
    the whole split's numbers."""

    def val(windows, labels, weights, *, n_batches: int, batch_size: int, globals_=None):
        if group is not None:
            return _val_dp(windows, labels, weights, n_batches, batch_size, globals_)
        losses, preds = [], []
        with torch.inference_mode():
            for i in range(n_batches):
                sl = slice(i * batch_size, (i + 1) * batch_size)
                g = (globals_[sl],) if use_global else ()
                logits = first_head(apply_logits(windows[sl][:, None], *g))
                losses.append(weighted_ce(logits, labels[sl], weights[sl]))
                preds.append(logits.argmax(-1))
        return torch.stack(losses).mean(), torch.cat(preds)

    def _val_dp(windows, labels, weights, n_batches, batch_size, globals_):
        if batch_size % group.world_size:
            raise ValueError(f"batch_size {batch_size} not divisible by "
                             f"{group.world_size} devices")
        k = batch_size // group.world_size
        sums = torch.zeros((n_batches, 2), dtype=torch.float32, device=windows.device)
        preds = torch.zeros(n_batches * batch_size, dtype=torch.float32, device=windows.device)
        with torch.inference_mode():
            for i in range(n_batches):
                sl = slice(i * batch_size + group.rank * k, i * batch_size + (group.rank + 1) * k)
                g = (globals_[sl],) if use_global else ()
                logits = first_head(apply_logits(windows[sl][:, None], *g))
                sums[i, 0] = weighted_nll_sum(logits, labels[sl], weights[sl])
                sums[i, 1] = (weights[sl] > 0).sum()
                preds[sl] = logits.argmax(-1).to(torch.float32)
            flat = group.sum_(torch.cat([sums.reshape(-1), preds]))
        sums = flat[:2 * n_batches].view(n_batches, 2)
        return ((sums[:, 0] / torch.clamp(sums[:, 1], min=1.0)).mean(),
                flat[2 * n_batches:].long())

    return val


def _run_epoch_loop(state: TrainState, cfg: ExperimentConfig, *, train_epoch, val_epoch,
                    test_epoch, m_total: int, n_real: Optional[int] = None,
                    needs_order: bool = True, resume_path: Optional[str] = None,
                    verbose: bool = False, epoch_callback=None, group=None) -> FitResult:
    """The epoch loop of every fold driver (both device drivers and
    :func:`sept_tpu_torch.train.loop.fit`).  ``train_epoch(state, epoch,
    order) -> (state, {'loss', 'acc'})``, ``val_epoch(state) -> {'loss',
    'acc', 'uar'}`` and ``test_epoch(state) -> run_test's dict`` close over
    the workload's splits; the best-state tracking, plateau scaling, early
    stopping, mid-fold save / restore with the shuffle replayed, and the
    FitResult live here once.  ``epoch_callback(state) -> dict`` adds
    per-epoch observables to the history (the cloak's sigma statistics).
    ``needs_order=False``: the caller shuffles itself (``fit``'s
    ``batch_iterator``), so no permutation is drawn and ``order`` is None;
    such a caller cannot resume, since replay restores this loop's stream
    only.  ``group``: rank 0 alone prints and writes the mid-fold
    checkpoints."""
    if not needs_order and resume_path is not None:
        raise ValueError("resume requires the loop-owned shuffle stream (needs_order=True); a "
                         "needs_order=False caller shuffles in its own generator, which "
                         "replay cannot restore")
    verbose = verbose and is_main(group)
    rng = np.random.default_rng(cfg.seed)
    early = EarlyStopping(patience=cfg.early_stop_patience)
    plateau = PlateauScheduler(cfg.plateau_patience, cfg.plateau_factor)
    min_sel = min(cfg.min_select_epoch, cfg.num_epochs - 2)

    best_val_acc, best_epoch = 0.0, 0
    # a copy: the live state goes on training in place
    best_state = state.snapshot()
    # the in-memory best is not on disk yet; once written, an unchanged best
    # is not written again every epoch
    best_dirty = True
    final = {"acc": 0.0, "uar": 0.0, "conf": np.zeros((0, 0))}
    history = []

    mid = MidFoldCheckpoint(resume_path, group) if resume_path else None
    start_epoch = 0
    if mid is not None and mid.exists():
        snap, best_loaded, loop = mid.restore(state.generator.device)
        state.load(snap)
        start_epoch, best_val_acc, best_epoch, final, history = _loop_restore(
            loop, early, plateau)
        if best_loaded is not None:
            best_state = best_loaded
            best_dirty = False  # the best on disk is current
        for _ in range(start_epoch):  # replay the shuffle stream
            rng.permutation(n_real if n_real is not None else m_total)
        if verbose:
            print(f"mid-fold resume: continuing at epoch {start_epoch}")

    def next_order():
        if not needs_order:
            return None
        # shuffle the real rows only; the pad rows stay in the last batch, so
        # they never enter train-mode BatchNorm statistics mid-epoch
        if n_real is None or n_real == m_total:
            return rng.permutation(m_total)
        return np.concatenate([rng.permutation(n_real), np.arange(n_real, m_total)])

    for epoch in range(start_epoch, cfg.num_epochs):
        state, train_m = train_epoch(state, epoch, next_order())
        val_m = val_epoch(state)
        test_m = test_epoch(state)
        entry = {"train": train_m, "validate": val_m, "test": test_m}
        if epoch_callback is not None:
            entry.update(epoch_callback(state))
        history.append(entry)

        if cfg.optimizer == "adam":
            set_lr_scale(state.optimizer, plateau.step(val_m["loss"]))
        # STRICT >: ties keep the FIRST best epoch, like the reference
        if val_m["acc"] > best_val_acc and epoch > min_sel:
            best_val_acc, best_epoch, best_state, final = (
                val_m["acc"], epoch, state.snapshot(), test_m)
            best_dirty = True
        if verbose:
            print(f"epoch {epoch}: train loss {train_m['loss']:.4f} "
                  f"acc {train_m['acc']:.3f} | val acc {val_m['acc']:.3f} | "
                  f"test acc {test_m['acc']:.3f} uar {test_m['uar']:.3f}")
        if epoch > min_sel:  # patience accrues only once selection opens
            early(val_m["loss"])
        should_stop = early.should_stop and (
            cfg.optimizer != "sgd" or cfg.early_stop_with_sgd)
        if mid is not None and not should_stop:
            mid.save(state.snapshot(), best_state if best_dirty else None, _loop_snapshot(
                epoch, best_val_acc, best_epoch, early, plateau, final, history))
            best_dirty = False
        if should_stop:
            if verbose:
                print("early stopping")
            break

    if mid is not None:
        mid.delete()  # fold complete: the final artifact supersedes it
    return FitResult(best_state=best_state, best_epoch=best_epoch,
                     best_val_acc=best_val_acc, final_test_acc=final["acc"],
                     final_test_uar=final["uar"], final_confusion=final["conf"],
                     history=history)


def _epoch_metrics(losses, correct, counts) -> dict:
    return {"loss": float(losses.mean()),
            "acc": float(correct.sum() / torch.clamp(counts.sum(), min=1e-8))}


def _val_epoch(val_pass, ds: DeviceSplit):
    def val_epoch(state):
        loss, preds = val_pass(ds.windows, ds.labels, ds.weights, n_batches=ds.n_batches,
                               batch_size=ds.batch_size, globals_=ds.globals)
        valid = ds.weights.cpu().numpy() > 0
        acc, uar = _masked_uar(ds.labels.cpu().numpy(), preds.cpu().numpy(), valid)
        return {"loss": float(loss), "acc": acc, "uar": uar}

    return val_epoch


def fit_device(state: TrainState, train_split: SplitArrays, val_split: SplitArrays,
               test_split: SplitArrays, cfg: ExperimentConfig, logits_fn: Callable,
               spk_weights: Optional[dict] = None, verbose: bool = True,
               resume_path: Optional[str] = None, group=None) -> FitResult:
    """One fold of baseline / adversary / multitask training on the state's
    device.  ``logits_fn`` is the model's eval forward
    (:func:`sept_tpu_torch.train.steps.make_eval_logits_fn`).
    ``resume_path``: mid-fold checkpoint directory (train.midfold): the whole
    state and the loop's bookkeeping persist after every epoch, an
    interrupted fold resumes at the next epoch with the same shuffle, and
    the directory goes once the fold completes.  ``group``: run the fold
    data-parallel (see the module docstring); every rank calls this with
    the same arguments and gets the same FitResult."""
    dev = state.generator.device
    label_key = "labels_gen" if cfg.pred == "gender" else "labels_emo"
    train_ds = DeviceSplit(train_split, label_key, cfg.batch_size,
                           _spk_weight_vec(train_split, spk_weights), dev)
    val_ds = DeviceSplit(val_split, label_key, cfg.batch_size,
                         _spk_weight_vec(val_split, spk_weights), dev)
    if group is None:
        run_epoch = make_epoch_runner(pooling=pooling_for(cfg.model_type),
                                      use_global=cfg.global_feature)
    else:
        run_epoch = make_epoch_runner_dp(group, pooling_for(cfg.model_type), cfg.global_feature)
        broadcast_state(state, group)
    gkw = {"globals_": train_ds.globals} if cfg.global_feature else {}
    if cfg.pred == "multitask":
        gkw["labels_gen"] = train_ds.labels_gen

    def train_epoch(st, epoch, order):
        st, losses, correct, counts = run_epoch(
            st, train_ds.windows, train_ds.labels, train_ds.weights, order,
            n_batches=train_ds.n_batches, batch_size=train_ds.batch_size, **gkw)
        return st, _epoch_metrics(losses, correct, counts)

    return _run_epoch_loop(
        state, cfg, train_epoch=train_epoch,
        val_epoch=_val_epoch(make_val_pass(logits_fn, cfg.global_feature, group), val_ds),
        test_epoch=lambda st: run_test(logits_fn, test_split, cfg, device=dev, group=group),
        m_total=train_ds.n_batches * train_ds.batch_size, n_real=train_ds.n_real,
        resume_path=resume_path, verbose=verbose, group=group)


def fit_device_cloak(state: TrainState, train_split: SplitArrays, val_split: SplitArrays,
                     test_split: SplitArrays, cfg: ExperimentConfig,
                     eval_logits_fn: Callable, mask=None,
                     spk_weights: Optional[dict] = None, verbose: bool = True,
                     resume_path: Optional[str] = None, epoch_callback=None,
                     eps: Optional[Sequence[torch.Tensor]] = None, group=None) -> FitResult:
    """One fold of cloak / cloak + GRL training (``cfg.grl``) on the state's
    device.  ``eval_logits_fn`` runs the cloaked model's eval forward with
    one fixed epsilon draw (as the cloak's ``run_fold`` builds it).
    ``mask``: the suppression mask (win_len, n_feats), or None.  ``eps``:
    the training draws to inject, ``eps[epoch]`` of shape (n_batches, 1,
    win_len, n_feats) (the tests feed the JAX draws); else each step draws
    from the state's generator.  ``resume_path`` and ``group``: see
    :func:`fit_device`."""
    dev = state.generator.device
    train_ds = DeviceSplit(train_split, "labels_emo", cfg.batch_size,
                           _spk_weight_vec(train_split, spk_weights), dev)
    val_ds = DeviceSplit(val_split, "labels_emo", cfg.batch_size,
                         _spk_weight_vec(val_split, spk_weights), dev)
    mask_t = None if mask is None else torch.as_tensor(mask, dtype=torch.float32, device=dev)
    opts = dict(
        scale_lambda=cfg.scale_lambda, gender_lambda=cfg.gender_lambda, grl=cfg.grl,
        apply_scale_reg=cfg.suppression_ratio == 0, pooling=pooling_for(cfg.model_type),
        antithetic=cfg.antithetic_noise, saliency_align=cfg.saliency_align,
        use_global=cfg.global_feature)
    if group is None:
        run_epoch = make_cloak_epoch_runner(**opts)
    else:
        run_epoch = make_cloak_epoch_runner_dp(group, **opts)
        broadcast_state(state, group)

    def train_epoch(st, epoch, order):
        st, losses, correct, counts = run_epoch(
            st, train_ds.windows, train_ds.labels_emo, train_ds.labels_gen,
            train_ds.weights, order, mask_t, n_batches=train_ds.n_batches,
            batch_size=train_ds.batch_size, eps=None if eps is None else eps[epoch],
            globals_=train_ds.globals)
        return st, _epoch_metrics(losses, correct, counts)

    return _run_epoch_loop(
        state, cfg, train_epoch=train_epoch,
        val_epoch=_val_epoch(make_val_pass(eval_logits_fn, cfg.global_feature, group),
                             val_ds),
        test_epoch=lambda st: run_test(eval_logits_fn, test_split, cfg, device=dev,
                                       group=group),
        m_total=train_ds.n_batches * train_ds.batch_size, n_real=train_ds.n_real,
        resume_path=resume_path, verbose=verbose, epoch_callback=epoch_callback,
        group=group)
