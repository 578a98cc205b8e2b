"""CLI: baseline SER and gender-adversary training (the reference's
training_adversary_baselines.py).

    python -m sept_tpu_torch.cli.train_baseline --dataset synthetic --pred emotion
    python -m sept_tpu_torch.cli.train_baseline --dataset synthetic --pred gender --adv 1

Counterpart of ``sept_tpu/cli/train_baseline.py``: per fold, load the
assembled splits (``<work_dir>/folds/<dataset>/fold<k>.npz``), train the
configured backbone on the fold's (adversary) splits with
best-by-validation-accuracy selection, vote on the test split, and
checkpoint the best state_dict under
``<output_dir>/{baseline|adv_baseline}_<pred>[_bf16]/fold<k>``, with the
per-epoch metrics (``metrics.jsonl``) and the run's ``run.json`` beside it.
Under SGD the lr defaults to 1e-4 and the epochs to 100 (an explicit
``--num_epochs`` is honoured), under Adam the lr to 5e-5; Adam's plateau is
Plateau(3, 0.2).  ``--resume`` skips folds whose checkpoint exists and
continues an interrupted fold from its last epoch (``mid_fold<k>``).
``--n_devices`` trains data-parallel (see :mod:`sept_tpu_torch.cli.common`):
the model takes sync-BN over the ranks, and rank 0 writes.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from sept_tpu_torch.cli.common import (add_common_args, config_from_args, printer,
                                       resolve_group, setup_seed, spawn_ranks)
from sept_tpu_torch.device import resolve_device
from sept_tpu_torch.models import N_GLOBAL, build_backbone, compute_dtype, pooling_for
from sept_tpu_torch.parallel import barrier, is_main
from sept_tpu_torch.train.device_loop import fit_device
from sept_tpu_torch.train.loop import speaker_weights
from sept_tpu_torch.train.optim import make_optimizer
from sept_tpu_torch.train.steps import init_state, make_eval_logits_fn
from sept_tpu_torch.utils.logging import MetricsLogger, RunManifest

__all__ = ["artifact_name", "main", "run_fold", "seeded_backbone"]


def artifact_name(cfg) -> str:
    base = "adv_baseline" if cfg.adv else "baseline"
    name = f"{base}_{cfg.pred}"
    # non-default training numerics are part of the artifact's identity: a
    # bf16-trained checkpoint must not collide with (or resume) an f32 one
    if cfg.compute_dtype != "float32":
        name += "_bf16"
    return name


def seeded_backbone(cfg, pred: str, bn_group=None):
    """``build_backbone`` of ``cfg``'s model with ``pred``'s head (its
    ``dense1`` taking the 88-dim global feature with ``cfg.global_feature``),
    its weights initialized from ``cfg.seed`` (torch's global generator is
    left as it was); ``bn_group``: sync-BN over a data-parallel group (the
    2-D CNN + RNN family only, as in the JAX package)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        return build_backbone(cfg.model_type, hidden_size=cfg.hidden_size,
                              feature_len=cfg.feature_len, win_len=cfg.win_len, pred=pred,
                              att=cfg.att,
                              attention_size=cfg.attention_size,
                              compute_dtype=compute_dtype(cfg.compute_dtype),
                              global_dim=N_GLOBAL if cfg.global_feature else 0,
                              bn_group=bn_group)


def run_fold(cfg, fold, ckpt, verbose=True, metrics_path=None, resume_path=None,
             device="cuda", group=None):
    """Train one fold on ``device``; returns the FitResult.  ``ckpt`` is a
    :class:`sept_tpu_torch.train.checkpoint.CheckpointManager`;
    ``metrics_path`` a JSONL file that gets one line an epoch;
    ``resume_path`` a mid-fold checkpoint directory (see ``fit_device``).
    ``group``: every rank of a data-parallel group calls this; the model
    takes sync-BN over it, and rank 0 writes the metrics and the
    checkpoint."""
    dev = resolve_device(device)
    train_split = fold.adv_training if cfg.adv else fold.training
    val_split = fold.adv_validation if cfg.adv else fold.validation
    model = seeded_backbone(cfg, cfg.pred, group)
    # ceil: the padded partial batch is a step too, and the schedule turns
    # steps into epochs by dividing by this
    steps_per_epoch = max(1, -(-len(train_split) // cfg.batch_size))
    state = init_state(model, make_optimizer(cfg, steps_per_epoch, model), cfg.seed, dev)
    logits_fn = make_eval_logits_fn(model, cfg.global_feature,
                                    pooling=pooling_for(cfg.model_type))
    spk_w = speaker_weights(train_split) if "combine" in cfg.dataset else None
    result = fit_device(state, train_split, val_split, fold.test, cfg, logits_fn,
                        spk_weights=spk_w, verbose=verbose, resume_path=resume_path,
                        group=group)
    if is_main(group):
        _write_fold(cfg, fold, ckpt, result, metrics_path)
    barrier(group)
    return result


def _write_fold(cfg, fold, ckpt, result, metrics_path):
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


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--resume", action="store_true",
                   help="skip folds whose checkpoint already exists")
    args = p.parse_args(argv)
    resolve_device(args.device)
    ranks = spawn_ranks(main, argv, args)
    if ranks is not None:
        return ranks[0]
    group = resolve_group(args)
    device = group.device if group is not None else resolve_device(args.device)
    setup_seed(args.seed)
    cfg = config_from_args(args)
    if args.learning_rate is None:
        cfg.learning_rate = 1e-4 if cfg.optimizer == "sgd" else 5e-5
    if args.num_epochs is None and cfg.optimizer == "sgd":
        # the reference runs 100 epochs under SGD whatever --num_epochs says
        # (training_adversary_baselines.py:440); an explicit flag is honoured
        cfg.num_epochs = 100
    # Plateau(patience=3, factor=0.2) for adam baselines (:429)
    cfg.plateau_patience, cfg.plateau_factor = 3, 0.2

    from sept_tpu_torch.data.store import load_fold
    from sept_tpu_torch.train.checkpoint import CheckpointManager

    fold_dir = os.path.join(args.work_dir, "folds", cfg.dataset)
    ckpt = CheckpointManager(cfg.output_dir)
    metrics_path = os.path.join(cfg.output_dir, artifact_name(cfg), "metrics.jsonl")
    accs, uars = [], []
    say = printer(group)
    for k in args.folds or range(1, cfg.n_folds + 1):
        if args.resume and ckpt.exists(artifact_name(cfg), k):
            say(f"fold{k}: checkpoint exists, skipping (--resume)")
            continue
        fold = load_fold(os.path.join(fold_dir, f"fold{k}.npz"))
        # --resume also checkpoints every epoch: an interrupted fold
        # continues from its last completed epoch
        resume_path = (os.path.join(cfg.output_dir, artifact_name(cfg), f"mid_fold{k}")
                       if args.resume else None)
        result = run_fold(cfg, fold, ckpt, verbose=is_main(group), metrics_path=metrics_path,
                          resume_path=resume_path, device=device, group=group)
        accs.append(result.final_test_acc)
        uars.append(result.final_test_uar)
        say(f"fold{k}: best epoch {result.best_epoch} "
            f"test acc {result.final_test_acc:.3f} uar {result.final_test_uar:.3f}")
    if is_main(group):
        _print_summary(cfg, accs, uars)
        _write_run_manifest(cfg, accs, uars, args, device)
    barrier(group)


def _print_summary(cfg, accs, uars):
    if accs:
        print(f"{artifact_name(cfg)}: mean test acc {np.mean(accs):.3f} "
              f"uar {np.mean(uars):.3f} over {len(accs)} folds")
    else:
        print(f"{artifact_name(cfg)}: all folds resumed from existing "
              f"checkpoints, nothing trained")


def _write_run_manifest(cfg, accs, uars, args, device):
    manifest = RunManifest(os.path.join(cfg.output_dir, artifact_name(cfg), "run.json"),
                           cfg, device)
    manifest.record(mean_test_acc=float(np.mean(accs)) if accs else None,
                    mean_test_uar=float(np.mean(uars)) if uars else None,
                    folds=list(args.folds or range(1, cfg.n_folds + 1)))
    manifest.write()


if __name__ == "__main__":
    main()
