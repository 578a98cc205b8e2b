"""CLI: fold planning + split assembly (the reference's
adversary_data_preprocess.py + preprocess_adversary_data.py, without the
os.system process spawning).

    python -m sept_tpu_torch.cli.preprocess --dataset synthetic --work_dir work

Counterpart of ``sept_tpu/cli/preprocess.py``: reads the feature store
written by ``cli.featurize``, plans the speaker-disjoint folds, assembles
the windowed, normalized and augmented splits and writes
``<work_dir>/folds/<dataset>/fold<k>.npz``, the JAX package's files.
``--dataset combine`` / ``combine_two`` merge the corpora's folds.  Host
numpy only: ``--device`` is not read here.
"""

from __future__ import annotations

import argparse
import os

from sept_tpu_torch.cli.common import add_common_args, config_from_args, setup_seed


def round_robin_plans(speakers) -> list:
    """Five folds of a synthetic or custom corpus: test speakers by index
    mod 5, the rest halved into adversary and baseline pools, 20% of each
    (at least one speaker) carved out as validation from the front."""
    from sept_tpu_torch.data.splits import FoldPlan

    n = len(speakers)
    plans = []
    for k in range(5):
        test = [speakers[i] for i in range(n) if i % 5 == k]
        rest = [s for s in speakers if s not in test]
        half = len(rest) // 2
        adv, base = rest[:half], rest[half:]
        vb = max(1, round(len(base) * 0.2))
        va = max(1, round(len(adv) * 0.2))
        plans.append(FoldPlan(fold=k + 1, train=tuple(base[vb:]), validation=tuple(base[:vb]),
                              adv_train=tuple(adv[va:]), adv_validation=tuple(adv[:va]),
                              test=tuple(test)))
    return plans


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    args = p.parse_args(argv)
    setup_seed(args.seed)
    cfg = config_from_args(args)

    if cfg.dataset in ("combine", "combine_two"):
        return _combine(args, cfg)

    from sept_tpu_torch.data.pipeline import assemble_fold
    from sept_tpu_torch.data.splits import plan_folds
    from sept_tpu_torch.data.store import load_feature_store, load_manifest, save_fold

    feat_dir = os.path.join(args.work_dir, "feature", cfg.feature_type, cfg.dataset)
    store = load_feature_store(os.path.join(feat_dir, f"data_{cfg.feature_len}.npz"))
    manifest = load_manifest(os.path.join(feat_dir, "manifest.json"))

    if cfg.dataset in ("iemocap", "crema-d", "msp-improv"):
        plans = plan_folds(cfg.dataset)
    else:
        # synthetic / custom corpora: round-robin speaker folds with the same
        # 40/40/20 economics as the reference planner
        plans = round_robin_plans(sorted({u.speaker_id for u in manifest}))

    out_dir = os.path.join(args.work_dir, "folds", cfg.dataset)
    os.makedirs(out_dir, exist_ok=True)
    fold_nums = args.folds or [pl.fold for pl in plans]
    for plan in plans:
        if plan.fold not in fold_nums:
            continue
        fold = assemble_fold(manifest, store, plan, dataset=cfg.dataset,
                             feature_type=cfg.feature_type, feature_len=cfg.feature_len,
                             win_len=cfg.win_len, norm=cfg.norm, aug=cfg.aug, seed=cfg.seed,
                             shift=cfg.shift)
        path = os.path.join(out_dir, f"fold{plan.fold}.npz")
        save_fold(path, fold)
        print(f"fold{plan.fold}: train {len(fold.training)} / val "
              f"{len(fold.validation)} / adv_train {len(fold.adv_training)} / "
              f"adv_val {len(fold.adv_validation)} / test {len(fold.test)} -> {path}")


def _combine(args, cfg):
    """--dataset combine | combine_two: merge the corpora's assembled folds
    (preprocess_adversary_data.py:86-104).  ``combine`` merges all three
    corpora; ``combine_two`` merges iemocap + crema-d only
    (training_adversary_baselines.py:53,148)."""
    from sept_tpu_torch.data.combine import combine_folds
    from sept_tpu_torch.data.store import load_fold, save_fold

    corpora = ("iemocap", "crema-d", "msp-improv")
    if cfg.dataset == "combine_two":
        corpora = ("iemocap", "crema-d")
    out_dir = os.path.join(args.work_dir, "folds", cfg.dataset)
    os.makedirs(out_dir, exist_ok=True)
    for k in args.folds or range(1, cfg.n_folds + 1):
        merged = combine_folds([load_fold(os.path.join(args.work_dir, "folds", ds,
                                                       f"fold{k}.npz")) for ds in corpora])
        path = os.path.join(out_dir, f"fold{k}.npz")
        save_fold(path, merged)
        print(f"{cfg.dataset} fold{k}: train {len(merged.training)} test "
              f"{len(merged.test)} -> {path}")


if __name__ == "__main__":
    main()
