"""Utility-privacy evaluation sweep.

Counterpart of ``sept_tpu/eval/sweep.py`` (the reference's
adversary_cloak_evaluation.py): for each suppression ratio in {0, 20, 40,
60, 80} and each fold, the test split's whole utterances go through the
trained cloak, and the *noised* windows through BOTH the frozen emotion
baseline and the frozen gender adversary (:class:`SweepModel`, the joint
forward the JAX CLI builds as a closure); a sliding-window softmax vote per
utterance and head; per-fold means in the reference CSV schema (columns
baseline_acc / baseline_rec / adv_acc / adv_rec, rows
``suppression_ratio_<r>_<dataset>``).

Mask semantics at evaluation (reference quirk 8, kept as the evaluation
contract): threshold = percentile(scales, ratio); cells whose scale is
ABOVE it are zeroed.  Training masks use percentile(100 - ratio).  The
cloak's noise runs with max_scale=5 at evaluation, 10 in training.
"""

from __future__ import annotations

import csv
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from sept_tpu_torch.data.pipeline import SplitArrays
from sept_tpu_torch.eval import metrics as M
from sept_tpu_torch.eval.sliding import make_sliding_vote_fn, vote_split
from sept_tpu_torch.models.cloak import CloakNoise
from sept_tpu_torch.train.steps import make_eval_logits_fn

__all__ = ["eval_mask", "train_mask", "SweepModel", "evaluate_cloaked_test", "SweepRow",
           "sweep_to_rows", "rows_to_csv", "EVAL_MAX_SCALE"]

EVAL_MAX_SCALE = 5.0  # the cloak's max_scale at evaluation


def eval_mask(scales: np.ndarray, suppression_ratio: int) -> Optional[np.ndarray]:
    """Evaluation-direction suppression mask: zero cells whose scale exceeds
    percentile(ratio); None at ratio 0."""
    if suppression_ratio == 0:
        return None
    thresh = np.nanpercentile(scales, int(suppression_ratio))
    return np.where(scales > thresh, 0.0, 1.0).astype(np.float32)


def train_mask(scales: np.ndarray, suppression_ratio: int) -> Optional[np.ndarray]:
    """Training-direction suppression mask: zero the top-ratio% noisiest
    cells (threshold percentile(100 - ratio)); None at ratio 0."""
    if suppression_ratio == 0:
        return None
    thresh = np.nanpercentile(scales, 100 - int(suppression_ratio))
    return np.where(scales > thresh, 0.0, 1.0).astype(np.float32)


class SweepModel(nn.Module):
    """The sweep's joint forward: windows (N, 1, T, D) -> the cloak's noise,
    ONE epsilon draw for the whole call, then the noised windows through the
    frozen emotion model and the frozen gender adversary, both with
    ``pooling`` (:func:`sept_tpu_torch.models.pooling_for` of their model
    type: the deep model flattens), logits concatenated (N, n_emo + n_adv).
    The noise layer runs with max_scale ``EVAL_MAX_SCALE``, the evaluation
    bound."""

    def __init__(self, emotion: nn.Module, adversary: nn.Module, win_len: int = 200,
                 n_feats: int = 128, pooling: Optional[str] = "mean"):
        super().__init__()
        self.noise = CloakNoise(win_len, n_feats, max_scale=EVAL_MAX_SCALE)
        self.emotion = emotion
        self.adversary = adversary
        self.pooling = pooling

    def load_cell(self, cloak: dict, baseline: dict, adversary: dict) -> "SweepModel":
        """One (ratio, fold) cell: the cloak artifact's ``noise.locs`` and
        ``noise.rhos``, the baseline's and the adversary's state_dicts."""
        self.noise.load_state_dict({k: cloak[f"noise.{k}"] for k in ("locs", "rhos")})
        self.emotion.load_state_dict(baseline)
        self.adversary.load_state_dict(adversary)
        return self

    def forward(self, wins: torch.Tensor, eps: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                global_feature: Optional[torch.Tensor] = None):
        """``global_feature`` (N, 88) goes to both frozen models."""
        noised = self.noise(wins[:, 0], mask=mask, eps=eps)[:, None]
        return torch.cat([
            self.emotion(noised, pooling=self.pooling, global_feature=global_feature),
            self.adversary(noised, pooling=self.pooling, global_feature=global_feature)], -1)


def evaluate_cloaked_test(model: SweepModel, test: SplitArrays, mask: Optional[np.ndarray],
                          win_len: int = 200, shift_len: int = 50, batch_size: int = 16,
                          noise_seed: int = 8, n_emo: int = 4, n_adv: int = 2,
                          eps: Optional[torch.Tensor] = None,
                          use_global: bool = False, group=None) -> tuple[dict, dict]:
    """The cloak -> frozen-models protocol on one test split, on the model's
    device, ``batch_size`` utterances a forward
    (:func:`sept_tpu_torch.eval.sliding.vote_split`).

    One epsilon (1, win_len, n_feats) is drawn per call from a generator
    seeded with ``noise_seed`` and every batch reuses it; ``eps`` injects
    the draw instead (the tests feed JAX's).  ``mask=None`` means no
    suppression: the same output as an all-ones mask (``x*1 + noise*1``).
    Everything runs in eval mode under ``torch.inference_mode``.
    ``use_global``: each utterance's 88-dim ``global_data`` row goes to
    both frozen models beside its noised windows, the only semantics that
    matches how models trained with the global feature see their input
    (the JAX package's reading of the reference's eval path).  Returns
    (baseline_result, adversary_result) dicts with acc / rec / conf, a
    ``per_dataset`` breakdown when the split mixes corpora (combine mode),
    and the voted ``probs`` of each head (N, n_emo) and (N, n_adv).

    ``group``: a data-parallel group (the JAX package's ``mesh``) whose
    ranks all call this with the same arguments: each batch is padded to a
    multiple of the world size, each rank votes its rows, and every rank
    returns the whole result, equal to one device's (eval mode: every row's
    forward stands alone)."""
    dev = model.noise.locs.device
    if eps is None:
        eps = model.noise.draw_eps(torch.Generator(device=dev).manual_seed(noise_seed))
    mask_t = None if mask is None else torch.as_tensor(mask, dtype=torch.float32, device=dev)
    vote = make_sliding_vote_fn(make_eval_logits_fn(model, use_global, eps=eps.to(dev),
                                                    mask=mask_t),
                                win_len, shift_len, head_sizes=(n_emo, n_adv))
    probs = vote_split(vote, test, win_len, batch_size, dev, use_global, group)
    baseline = M.split_result(test.labels_emo, np.argmax(probs[:, :n_emo], -1), test.datasets)
    adversary = M.split_result(test.labels_gen, np.argmax(probs[:, n_emo:], -1), test.datasets)
    baseline["probs"], adversary["probs"] = probs[:, :n_emo], probs[:, n_emo:]
    return baseline, adversary


@dataclasses.dataclass
class SweepRow:
    """One reference CSV row."""

    suppression_ratio: int
    dataset: str
    baseline_acc: float
    baseline_rec: float
    adv_acc: float
    adv_rec: float

    @property
    def index(self) -> str:
        return f"suppression_ratio_{self.suppression_ratio}_{self.dataset}"


def _row(ratio, dataset, pairs) -> SweepRow:
    return SweepRow(suppression_ratio=ratio, dataset=dataset,
                    baseline_acc=float(np.mean([b["acc"] for b, _ in pairs])),
                    baseline_rec=float(np.mean([b["rec"] for b, _ in pairs])),
                    adv_acc=float(np.mean([a["acc"] for _, a in pairs])),
                    adv_rec=float(np.mean([a["rec"] for _, a in pairs])))


def sweep_to_rows(per_fold: dict[int, list[tuple[dict, dict]]], dataset: str) -> list[SweepRow]:
    """Aggregate {ratio: [(baseline, adversary) per fold]} into CSV rows:
    one row of fold means per ratio, and in combine mode one more per
    constituent corpus from the results' ``per_dataset`` breakdown."""
    rows = []
    for ratio, fold_results in per_fold.items():
        rows.append(_row(ratio, dataset, fold_results))
        corpora = sorted({ds for b, _ in fold_results for ds in b.get("per_dataset", {})})
        for ds in corpora:
            rows.append(_row(ratio, ds, [(b["per_dataset"][ds], a["per_dataset"][ds])
                                         for b, a in fold_results
                                         if ds in b.get("per_dataset", {})]))
    return rows


def rows_to_csv(rows: Sequence[SweepRow], path: str) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "baseline_acc", "baseline_rec", "adv_acc", "adv_rec"])
        for r in rows:
            w.writerow([r.index, r.baseline_acc, r.baseline_rec, r.adv_acc, r.adv_rec])
