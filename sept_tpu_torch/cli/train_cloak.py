"""CLI: cloak noise-injection training (the reference's training_cloak.py
and, with ``--grl 1``, training_cloak_with_grl.py).

    python -m sept_tpu_torch.cli.train_cloak --dataset synthetic --scale_lamda 0.1
    python -m sept_tpu_torch.cli.train_cloak --dataset synthetic --grl 1

Counterpart of ``sept_tpu/cli/train_cloak.py``: per fold, load the fold's
pretrained emotion baseline (``cli.train_baseline``), wrap it with the
noise layer (and, for GRL, a fresh trainable gender adversary behind the
gradient-reversal layer), and train only the cloak's trainable part.
Suppression runs (``--suppression_ratio`` > 0) start from the
suppression-0 cloak's noise, freeze ``rhos`` and train under the
training-direction percentile mask (``--mask_direction eval``: under the
sweep's mask).  Under SGD the lr defaults to 1e-3, under Adam to 5e-4;
StepLR steps every 10 epochs; ``--grl 1`` steps the schedule once an epoch
and takes Plateau(3, 0.5).  Artifacts:
``cloak[_grl]_lamda<scale_lambda>_supp<r>[_anti][_sal<w>][_mdeval][_bf16]/
fold<k>``.  With ``--global_feature 1`` the frozen baseline and the GRL
adversary both take the 88-dim global vector (the adversary's ``dense1``
built pooled + 88 wide).  ``--n_devices`` trains data-parallel (see
:mod:`sept_tpu_torch.cli.common`): the GRL adversary, which trains, takes
sync-BN over the ranks (the frozen emotion backbone runs eval-mode BN and
needs none), and rank 0 writes.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from sept_tpu_torch.cli.common import (add_common_args, config_from_args, printer,
                                       resolve_group, setup_seed, spawn_ranks)
from sept_tpu_torch.cli.train_baseline import artifact_name as baseline_artifact
from sept_tpu_torch.cli.train_baseline import seeded_backbone
from sept_tpu_torch.device import resolve_device
from sept_tpu_torch.eval.sweep import eval_mask, train_mask
from sept_tpu_torch.models import CloakedModel, CloakedModelGRL, pooling_for
from sept_tpu_torch.parallel import barrier, is_main
from sept_tpu_torch.train.device_loop import fit_device_cloak
from sept_tpu_torch.train.loop import speaker_weights
from sept_tpu_torch.train.optim import make_cloak_optimizer
from sept_tpu_torch.train.steps import cloak_scales, init_state, make_eval_logits_fn

__all__ = ["cloak_artifact", "main", "run_fold"]

# validation and test votes of a cloak run all see the epsilon drawn from
# this seed (the JAX package's PRNGKey(0))
EVAL_NOISE_SEED = 0


def cloak_artifact(cfg) -> str:
    """Checkpoint directory name of a cloak training configuration: every
    knob that changes WHAT the trained cloak is, the framework's training
    extensions included, so that cloaks trained under different regimes
    never share an artifact."""
    tag = "cloak_grl" if cfg.grl else "cloak"
    name = f"{tag}_lamda{cfg.scale_lambda}_supp{cfg.suppression_ratio}"
    if cfg.antithetic_noise:
        name += "_anti"
    if cfg.saliency_align:
        name += f"_sal{cfg.saliency_align:g}"
    # the mask direction only shapes suppressed training; suppression-0
    # cloaks are shared between directions
    if cfg.suppression_ratio and cfg.mask_direction == "eval":
        name += "_mdeval"
    if cfg.compute_dtype != "float32":
        name += "_bf16"
    return name


def run_fold(cfg, fold, ckpt, verbose=True, resume_path=None, device="cuda", group=None):
    """Train one fold's cloak on ``device`` from the checkpoints in ``ckpt``
    (the baseline, and for a suppression run the suppression-0 cloak);
    returns the FitResult and saves the best state_dict under
    :func:`cloak_artifact`.  ``group``: every rank of a data-parallel group
    calls this; rank 0 saves."""
    dev = resolve_device(device)
    backbone = seeded_backbone(cfg, "emotion")
    base_cfg = dataclasses.replace(cfg, adv=False, pred="emotion")
    # graft the pretrained frozen backbone in
    backbone.load_state_dict(ckpt.restore(baseline_artifact(base_cfg), fold.fold, dev))
    noise_kw = dict(win_len=cfg.win_len, n_feats=cfg.feature_len,
                    min_scale=cfg.noise_min_scale, max_scale=cfg.noise_max_scale)
    if cfg.grl:
        model = CloakedModelGRL(backbone, seeded_backbone(cfg, "gender", group),
                                grl_lambda=cfg.grl_lambda, **noise_kw)
        trainable = ("noise", "gender_backbone")
    else:
        model = CloakedModel(backbone, **noise_kw)
        trainable = ("noise",)

    mask = None
    if cfg.suppression_ratio:
        supp0 = ckpt.restore(cloak_artifact(dataclasses.replace(cfg, suppression_ratio=0)),
                             fold.fold, dev)
        model.noise.load_state_dict({k: supp0[f"noise.{k}"] for k in ("locs", "rhos")})
        scales = cloak_scales(model).detach()[0].cpu().numpy()
        mask_fn = eval_mask if cfg.mask_direction == "eval" else train_mask
        mask = mask_fn(scales, cfg.suppression_ratio)

    steps_per_epoch = max(1, -(-len(fold.training) // cfg.batch_size))
    opt = make_cloak_optimizer(cfg, steps_per_epoch, model, trainable,
                               freeze_rhos=bool(cfg.suppression_ratio))
    state = init_state(model, opt, cfg.seed, dev)
    # validation and test: the cloak forward with one fixed noise draw
    eps0 = model.noise.draw_eps(torch.Generator(device=dev).manual_seed(EVAL_NOISE_SEED))
    mask_t = None if mask is None else torch.as_tensor(mask, device=dev)
    eval_logits = make_eval_logits_fn(model, cfg.global_feature, eps=eps0, mask=mask_t,
                                      pooling=pooling_for(cfg.model_type))
    spk_w = speaker_weights(fold.training) if "combine" in cfg.dataset else None

    def sigma_stats(st):
        # the reference prints these every epoch; kept in the history
        s = cloak_scales(st.model).detach().cpu().numpy()
        return {"sigma_log_mean": float(np.log(s.mean())),
                "sigma_mean": float(s.mean()), "sigma_max": float(s.max())}

    result = fit_device_cloak(state, fold.training, fold.validation, fold.test, cfg,
                              eval_logits, mask=mask, spk_weights=spk_w, verbose=verbose,
                              resume_path=resume_path, epoch_callback=sigma_stats,
                              group=group)
    model.load_state_dict(result.best_state["model"])
    scales = cloak_scales(model).detach().cpu().numpy()
    if is_main(group):
        _save(cfg, fold, ckpt, result, scales, verbose)
    barrier(group)
    return result


def _save(cfg, fold, ckpt, result, scales, verbose):
    ckpt.save(cloak_artifact(cfg), fold.fold, result.best_state["model"], manifest={
        "config": cfg,
        "best_epoch": result.best_epoch,
        "test_acc": result.final_test_acc,
        "test_uar": result.final_test_uar,
        "scales_mean": float(scales.mean()),
        "scales_max": float(scales.max()),
        "scales_min": float(scales.min()),
        "sigma_log_mean_trajectory": [h.get("sigma_log_mean") for h in result.history],
    })
    if verbose:
        print("scales mean/max/min %.3f/%.3f/%.3f"
              % (scales.mean(), scales.max(), scales.min()))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--grl", type=int, default=0)
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
    cfg = config_from_args(args, grl=bool(args.grl))
    if args.learning_rate is None:
        cfg.learning_rate = 1e-3 if cfg.optimizer == "sgd" else 5e-4
    cfg.lr_step_epochs = 10  # cloak StepLR(10, 0.5) (training_cloak.py:379)
    if cfg.grl:
        # the GRL trainer steps StepLR once per epoch (only on the validate
        # pass, training_cloak_with_grl.py:186-191) and uses
        # Plateau(patience=3, factor=0.5) (:421)
        cfg.lr_sched_steps_per_epoch = 1
        cfg.plateau_patience, cfg.plateau_factor = 3, 0.5

    from sept_tpu_torch.data.store import load_fold
    from sept_tpu_torch.train.checkpoint import CheckpointManager

    fold_dir = os.path.join(args.work_dir, "folds", cfg.dataset)
    ckpt = CheckpointManager(cfg.output_dir)
    accs, uars = [], []
    say = printer(group)
    for k in args.folds or range(1, cfg.n_folds + 1):
        if args.resume and ckpt.exists(cloak_artifact(cfg), k):
            say(f"fold{k}: checkpoint exists, skipping (--resume)")
            continue
        fold = load_fold(os.path.join(fold_dir, f"fold{k}.npz"))
        resume_path = (os.path.join(cfg.output_dir, cloak_artifact(cfg), f"mid_fold{k}")
                       if args.resume else None)
        result = run_fold(cfg, fold, ckpt, verbose=is_main(group), resume_path=resume_path,
                          device=device, group=group)
        accs.append(result.final_test_acc)
        uars.append(result.final_test_uar)
        say(f"fold{k}: test acc {result.final_test_acc:.3f} "
            f"uar {result.final_test_uar:.3f}")
    if accs:
        say(f"{cloak_artifact(cfg)}: mean test acc {np.mean(accs):.3f} "
            f"uar {np.mean(uars):.3f}")
    else:
        say(f"{cloak_artifact(cfg)}: all folds resumed from existing "
            f"checkpoints, nothing trained")


if __name__ == "__main__":
    main()
