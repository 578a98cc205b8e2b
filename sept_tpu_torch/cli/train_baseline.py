"""Baseline SER and gender-adversary training of one fold (the reference's
training_adversary_baselines.py).

Counterpart of ``sept_tpu/cli/train_baseline.py``'s ``artifact_name`` and
``run_fold``: train the configured backbone on the fold's (adversary)
splits with best-by-validation-accuracy selection, vote on the test split,
and checkpoint the best state_dict under
``<output_dir>/{baseline|adv_baseline}_<pred>[_bf16]/fold<k>``.  The
argument parser (``main``), ``cli/common.py`` and the fold store
(``data/store.py``) come with the CLIs and host data (ROADMAP.md §1 item
9).
"""

from __future__ import annotations

import torch

from sept_tpu_torch.device import resolve_device
from sept_tpu_torch.models import build_backbone, compute_dtype, pooling_for
from sept_tpu_torch.train.device_loop import fit_device
from sept_tpu_torch.train.loop import speaker_weights
from sept_tpu_torch.train.optim import make_optimizer
from sept_tpu_torch.train.steps import init_state, make_eval_logits_fn
from sept_tpu_torch.utils.logging import MetricsLogger

__all__ = ["artifact_name", "run_fold", "seeded_backbone"]


def artifact_name(cfg) -> str:
    base = "adv_baseline" if cfg.adv else "baseline"
    name = f"{base}_{cfg.pred}"
    # non-default training numerics are part of the artifact's identity: a
    # bf16-trained checkpoint must not collide with (or resume) an f32 one
    if cfg.compute_dtype != "float32":
        name += "_bf16"
    return name


def seeded_backbone(cfg, pred: str):
    """``build_backbone`` of ``cfg``'s model with ``pred``'s head, its
    weights initialized from ``cfg.seed`` (torch's global generator is left
    as it was)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        return build_backbone(cfg.model_type, hidden_size=cfg.hidden_size,
                              feature_len=cfg.feature_len, pred=pred, att=cfg.att,
                              attention_size=cfg.attention_size,
                              compute_dtype=compute_dtype(cfg.compute_dtype))


def run_fold(cfg, fold, ckpt, verbose=True, metrics_path=None, resume_path=None,
             device="cuda"):
    """Train one fold on ``device``; returns the FitResult.  ``ckpt`` is a
    :class:`sept_tpu_torch.train.checkpoint.CheckpointManager`;
    ``metrics_path`` a JSONL file that gets one line an epoch;
    ``resume_path`` a mid-fold checkpoint directory (see ``fit_device``)."""
    dev = resolve_device(device)
    train_split = fold.adv_training if cfg.adv else fold.training
    val_split = fold.adv_validation if cfg.adv else fold.validation
    model = seeded_backbone(cfg, cfg.pred)
    # ceil: the padded partial batch is a step too, and the schedule turns
    # steps into epochs by dividing by this
    steps_per_epoch = max(1, -(-len(train_split) // cfg.batch_size))
    state = init_state(model, make_optimizer(cfg, steps_per_epoch, model), cfg.seed, dev)
    logits_fn = make_eval_logits_fn(model, pooling=pooling_for(cfg.model_type))
    spk_w = speaker_weights(train_split) if "combine" in cfg.dataset else None
    result = fit_device(state, train_split, val_split, fold.test, cfg, logits_fn,
                        spk_weights=spk_w, verbose=verbose, resume_path=resume_path)
    if metrics_path:
        log = MetricsLogger(metrics_path)
        for epoch, h in enumerate(result.history):
            log.log(fold=fold.fold, epoch=epoch,
                    train_loss=h["train"]["loss"], train_acc=h["train"]["acc"],
                    val_loss=h["validate"]["loss"], val_acc=h["validate"]["acc"],
                    test_acc=h["test"]["acc"], test_uar=h["test"]["uar"])
        log.close()
    ckpt.save(artifact_name(cfg), fold.fold, result.best_state["model"], manifest={
        "config": cfg,
        "best_epoch": result.best_epoch,
        "best_val_acc": result.best_val_acc,
        "test_acc": result.final_test_acc,
        "test_uar": result.final_test_uar,
    })
    return result
