"""CLI: utility-privacy evaluation sweep (the reference's
adversary_cloak_evaluation.py).

    python -m sept_tpu_torch.cli.evaluate --dataset synthetic --scale_lamda 0.1

Counterpart of ``sept_tpu/cli/evaluate.py``: for each suppression ratio in
{0, 20, 40, 60, 80} x fold, restore the trained cloak, the frozen emotion
baseline and the frozen gender adversary into one
:class:`sept_tpu_torch.eval.sweep.SweepModel` (built once for the whole
sweep, as the JAX CLI builds one joint function), mask the cells whose
scale lies above the ratio's percentile, run the test utterances through
the cloak (max_scale 5 at evaluation) and the noised windows through both
frozen models with the sliding-window vote, and write the fold means in
the reference CSV schema to ``<output_dir>/(non-)grl-<scale_lamda>.csv``.
With ``--global_feature 1`` both frozen models take each test utterance's
88-dim vector beside its noised windows, as they were trained.  With
``--n_devices`` (see :mod:`sept_tpu_torch.cli.common`) the ranks vote their
rows of each test batch, every rank gets every result, and rank 0 writes
the CSV.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from sept_tpu_torch.cli.common import (add_common_args, config_from_args, printer,
                                       resolve_group, setup_seed, spawn_ranks)
from sept_tpu_torch.device import resolve_device
from sept_tpu_torch.parallel import barrier, is_main


def main(argv=None):
    """Run the sweep; returns {ratio: [(baseline, adversary) per fold]},
    the results of ``evaluate_cloaked_test`` (voted ``probs`` included)."""
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--grl", type=int, default=0)
    p.add_argument("--ratios", type=int, nargs="*", default=[0, 20, 40, 60, 80])
    args = p.parse_args(argv)
    resolve_device(args.device)
    ranks = spawn_ranks(main, argv, args)
    if ranks is not None:
        return ranks[0]
    group = resolve_group(args)
    device = group.device if group is not None else resolve_device(args.device)
    say = printer(group)
    setup_seed(args.seed)
    cfg = config_from_args(args, grl=bool(args.grl))

    from sept_tpu_torch.cli.train_baseline import artifact_name as baseline_artifact
    from sept_tpu_torch.cli.train_cloak import cloak_artifact
    from sept_tpu_torch.data.store import load_fold
    from sept_tpu_torch.eval.sweep import (SweepModel, eval_mask, evaluate_cloaked_test,
                                           rows_to_csv, sweep_to_rows)
    from sept_tpu_torch.models import N_GLOBAL, build_backbone, pooling_for
    from sept_tpu_torch.train.checkpoint import CheckpointManager

    fold_dir = os.path.join(args.work_dir, "folds", cfg.dataset)
    ckpt = CheckpointManager(cfg.output_dir)
    backbone = dict(hidden_size=cfg.hidden_size, feature_len=cfg.feature_len,
                    win_len=cfg.win_len, att=cfg.att, attention_size=cfg.attention_size,
                    global_dim=N_GLOBAL if cfg.global_feature else 0)
    model = SweepModel(build_backbone(cfg.model_type, pred="emotion", **backbone),
                       build_backbone(cfg.model_type, pred="gender", **backbone),
                       win_len=cfg.win_len, n_feats=cfg.feature_len,
                       pooling=pooling_for(cfg.model_type)).to(device)
    emo_art = baseline_artifact(dataclasses.replace(cfg, adv=False, pred="emotion"))
    adv_art = baseline_artifact(dataclasses.replace(cfg, adv=True, pred="gender"))

    per_ratio = {}
    for ratio in args.ratios:
        fold_results = []
        for k in args.folds or range(1, cfg.n_folds + 1):
            fold = load_fold(os.path.join(fold_dir, f"fold{k}.npz"))
            cloak = cloak_artifact(dataclasses.replace(cfg, suppression_ratio=ratio))
            model.load_cell(ckpt.restore(cloak, k, device), ckpt.restore(emo_art, k, device),
                            ckpt.restore(adv_art, k, device))
            mask = eval_mask(model.noise.scales().detach()[0].cpu().numpy(), ratio)
            b, a = evaluate_cloaked_test(model, fold.test, mask, win_len=cfg.win_len,
                                         shift_len=cfg.shift_len, noise_seed=cfg.seed,
                                         use_global=cfg.global_feature, group=group)
            fold_results.append((b, a))
            say(f"ratio {ratio} fold{k}: baseline acc {b['acc']:.3f} "
                f"uar {b['rec']:.3f} | adversary acc {a['acc']:.3f} "
                f"uar {a['rec']:.3f}")
        per_ratio[ratio] = fold_results

    rows = sweep_to_rows(per_ratio, cfg.dataset)
    name = ("grl-" if cfg.grl else "non-grl-") + str(cfg.scale_lambda)
    out_csv = os.path.join(cfg.output_dir, f"{name}.csv")
    if is_main(group):
        os.makedirs(cfg.output_dir, exist_ok=True)
        rows_to_csv(rows, out_csv)
    barrier(group)
    say(f"wrote {out_csv}")
    for r in rows:
        say(f"  {r.index}: baseline {r.baseline_acc:.3f}/{r.baseline_rec:.3f} "
            f"adversary {r.adv_acc:.3f}/{r.adv_rec:.3f}")
    return per_ratio


if __name__ == "__main__":
    main()
