"""Explicit-collective data-parallel train step.

Counterpart of ``sept_tpu/parallel/shard_map_dp.py``
(``make_shard_map_dp_step``): one baseline / adversary / multitask step per
call, every rank given the same global batch and training its rows.  The
weighted-loss subtlety is the JAX module's: the global weighted CE is
``sum_i w_i l_i / #real rows`` over the WHOLE batch, not the mean of
per-rank means, so a rank backpropagates its local weighted sum, and the
all-reduce that sums the gradients also sums the real-row counts; the
gradients are divided by that count afterwards.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from sept_tpu_torch.device import f32_precision
from sept_tpu_torch.models.backbone import DropoutDraws
from sept_tpu_torch.parallel.epoch_dp import check_divisible
from sept_tpu_torch.parallel.mesh import DataGroup, rank_generator, sync_gradients
from sept_tpu_torch.train.steps import TrainState, baseline_loss, weighted_nll_sum

__all__ = ["make_dp_step"]


def make_dp_step(group: DataGroup, pooling: Optional[str] = "mean",
                 use_global: bool = False) -> Callable[[TrainState, dict], tuple]:
    """``step(state, batch) -> (state, metrics)`` with ``batch`` as
    ``make_baseline_step`` takes it, the whole batch on every rank; rank r
    trains rows ``[r * B/n, (r + 1) * B/n)``.  One all-reduce (besides the
    sync-BN ones) carries the gradients, the running statistics (averaged),
    the loss sum, the correct and real-row counts and the predictions, so
    ``metrics`` (``loss``, ``correct``, ``count``, ``preds`` (B,)) are the
    whole batch's on every rank.  With dropout on, each rank draws its own
    masks (:func:`~sept_tpu_torch.parallel.mesh.rank_generator`): valid DP
    training, not the single-device masks."""
    f32_precision()

    def step(state: TrainState, batch: dict):
        b = len(batch["weight"])
        check_divisible(b, group)
        k = b // group.world_size
        rows = slice(group.rank * k, (group.rank + 1) * k)
        model = state.model.train()
        key = "labels_gen" if model.pred == "gender" else "labels_emo"
        labels, w = batch[key][rows], batch["weight"][rows]
        loss_sum, logits = baseline_loss(
            model, batch["spec"][rows], labels, w, batch["labels_gen"][rows], pooling,
            batch["global"][rows] if use_global else None,
            DropoutDraws(rank_generator(state, group)), weighted_nll_sum)
        state.optimizer.zero_grad()
        loss_sum.backward()
        valid = (w > 0).to(torch.float32)
        preds = logits.detach().argmax(-1)
        all_preds = torch.zeros(b, dtype=torch.float32, device=preds.device)
        all_preds[rows] = preds.to(torch.float32)
        summed = sync_gradients(model, group, (loss_sum.detach(),
                                               ((preds == labels) * valid).sum(),
                                               valid.sum(), all_preds))
        n_real = summed[2]
        denom = torch.clamp(n_real, min=1.0)
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(denom)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": summed[0] / denom, "correct": summed[1], "count": n_real,
                       "preds": summed[3:].long()}

    return step
