"""Data-parallel whole-epoch runners.

Counterpart of ``sept_tpu/parallel/epoch_dp.py``: the DP forms of
:func:`sept_tpu_torch.train.steps.make_epoch_runner` and
``make_cloak_epoch_runner``, with their call signatures, run by every rank
of a :class:`~sept_tpu_torch.parallel.mesh.DataGroup`:

- the splits are replicated: every rank holds the windows, labels, weights
  and the shuffled ``order``; each batch of ``order`` is split by columns,
  rank r taking rows ``[r * B/n, (r + 1) * B/n)`` (``batch_size % n`` must
  be 0);
- the loss of a rank is its local weighted NLL sum over the GLOBAL real-row
  count (speaker weights scale numerators only), which every rank counts
  from the replicated weights of the whole batch, so no collective is
  needed for it; the raw gradients are then SUMMED over the ranks (no
  division by the world size) and equal the gradient of the global weighted
  mean;
- the cloak's scale regularizer and the GRL game's saliency term add 1/n of
  themselves on each rank, so the sum carries each once; the saliency term
  is per shard (its input gradients normalized over the rank's rows), JAX's
  local approximation;
- one all-reduce of one flat buffer a step carries the gradients (summed),
  the running statistics (averaged; a sync-BN model has equal ones on every
  rank) and the step's loss, correct and count (summed), so every rank
  returns the same metrics and steps to the same parameters;
- the models train with sync-BN (``bn_group``) for equality with one device
  to float association; dropout is drawn per rank
  (:func:`~sept_tpu_torch.parallel.mesh.rank_generator`), the cloak's
  epsilon from the state's generator, the same on every rank, or injected
  (``eps``);
- ``mask=None`` runs as an all-ones mask (the same values as no mask).
"""

from __future__ import annotations

from typing import Optional

import torch

from sept_tpu_torch.device import f32_precision
from sept_tpu_torch.models.backbone import DropoutDraws
from sept_tpu_torch.parallel.mesh import DataGroup, rank_generator, sync_gradients
from sept_tpu_torch.train.steps import (
    baseline_loss,
    cloak_loss,
    count_real,
    grl_loss,
    saliency_alignment_loss,
    scale_reg,
    weighted_nll_sum,
)

__all__ = ["make_epoch_runner_dp", "make_cloak_epoch_runner_dp"]


def check_divisible(batch_size: int, group: DataGroup) -> None:
    if batch_size % group.world_size:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"{group.world_size} devices")


def _shards(order, n_batches, batch_size, weights, group):
    """(this rank's rows, the global real-row count) of each batch."""
    order = torch.as_tensor(order, dtype=torch.long, device=weights.device)
    k = batch_size // group.world_size
    for i in range(n_batches):
        full = order[i * batch_size:(i + 1) * batch_size]
        yield full[group.rank * k:(group.rank + 1) * k], count_real(weights[full])


def _global_ce(denom):
    return lambda logits, labels, weights: weighted_nll_sum(logits, labels, weights) / denom


def _update(state, loss, logits, labels, weights, group):
    """Backward, the step's one flat all-reduce, the optimizer step; the
    summed metrics."""
    state.optimizer.zero_grad()
    loss.backward()
    valid = (weights > 0).to(torch.float32)
    correct = ((logits.detach().argmax(-1) == labels) * valid).sum()
    summed = sync_gradients(state.model, group, (loss.detach(), correct, valid.sum()))
    state.optimizer.step()
    state.step += 1
    return summed


def _stacked(metrics):
    m = torch.stack(metrics)
    return m[:, 0], m[:, 1], m[:, 2]


def make_epoch_runner_dp(group: DataGroup, pooling: Optional[str] = "mean",
                         use_global: bool = False):
    """DP form of ``make_epoch_runner``: ``run(state, windows (M, T, D),
    labels (M,), weights (M,), order (M,), n_batches, batch_size[,
    globals_][, labels_gen]) -> (state, losses, correct, counts)``, the
    metrics summed over the ranks."""
    f32_precision()

    def run(state, windows, labels, weights, order, *, n_batches: int, batch_size: int,
            globals_=None, labels_gen=None):
        check_divisible(batch_size, group)
        model = state.model
        if model.pred == "multitask" and labels_gen is None:
            raise ValueError("multitask epoch runner needs labels_gen")
        if use_global and globals_ is None:
            raise ValueError("use_global=True but no globals_ passed to run()")
        gen = rank_generator(state, group)
        metrics = []
        for idx, denom in _shards(order, n_batches, batch_size, weights, group):
            loss, logits = baseline_loss(
                model.train(), windows[idx][:, None], labels[idx], weights[idx],
                None if labels_gen is None else labels_gen[idx], pooling,
                globals_[idx] if use_global else None, DropoutDraws(gen), _global_ce(denom))
            metrics.append(_update(state, loss, logits, labels[idx], weights[idx], group))
        return (state, *_stacked(metrics))

    return run


def make_cloak_epoch_runner_dp(group: DataGroup, scale_lambda: float = 0.0,
                               gender_lambda: float = 0.1, grl: bool = False,
                               apply_scale_reg: bool = True, pooling: Optional[str] = "mean",
                               antithetic: bool = False, saliency_align: float = 0.0,
                               use_global: bool = False):
    """DP form of ``make_cloak_epoch_runner``: ``run(state, windows,
    labels_emo, labels_gen, weights, order, mask, n_batches, batch_size,
    eps=None, globals_=None) -> (state, losses, correct, counts)``.
    ``saliency_align`` applies to the GRL game only."""
    f32_precision()
    n_dev = group.world_size

    def run(state, windows, labels_emo, labels_gen, weights, order, mask, *,
            n_batches: int, batch_size: int, eps=None, globals_=None):
        check_divisible(batch_size, group)
        if use_global and globals_ is None:
            raise ValueError("use_global=True but no globals_ passed to run()")
        model = state.model
        if mask is None:
            mask = torch.ones(windows.shape[1:3], dtype=torch.float32, device=windows.device)
        gen = rank_generator(state, group)
        metrics = []
        for i, (idx, denom) in enumerate(_shards(order, n_batches, batch_size, weights,
                                                 group)):
            model.train()
            e = model.noise.draw_eps(state.generator) if eps is None else eps[i]
            spec, w = windows[idx][:, None], weights[idx]
            le, lg = labels_emo[idx], labels_gen[idx]
            g = globals_[idx] if use_global else None
            align = None
            if grl:
                if saliency_align:
                    align = saliency_alignment_loss(model, spec, le, lg, w, pooling, g)
                loss, logits, _ = grl_loss(model, spec, le, lg, w, e, mask, pooling,
                                           antithetic, gender_lambda, DropoutDraws(gen), g,
                                           _global_ce(denom))
                labels = le
            else:
                labels = le if model.backbone.pred == "emotion" else lg
                loss, logits = cloak_loss(model, spec, labels, w, e, mask, pooling,
                                          antithetic, g, _global_ce(denom))
            loss = scale_reg(model, loss, scale_lambda, apply_scale_reg, share=n_dev)
            if align is not None:
                loss = loss + saliency_align * align / n_dev
            metrics.append(_update(state, loss, logits, labels, w, group))
        return (state, *_stacked(metrics))

    return run
