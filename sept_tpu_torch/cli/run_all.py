"""CLI: the whole protocol in one process (the reference's shell scripts
feature_extraction.sh + training_data_preprocess.sh + the four training
drivers, with no os.system process spawning).

    python -m sept_tpu_torch.cli.run_all --dataset synthetic --num_epochs 15 \
        --folds 1 --scale_lamda 0.1

Counterpart of ``sept_tpu/cli/run_all.py``.  Stages: featurize ->
preprocess -> baseline -> adversary -> cloak (with ``--grl 1`` the GRL
cloak) at suppression 0, then at each nonzero ``--ratios`` -> the
evaluation sweep; every flag goes to every stage.  Featurize runs with its
defaults, the gemaps / emobase functionals included, so ``--global_feature
1`` trains and evaluates on the 88-dim vectors.  ``--n_devices`` goes to
every stage: the training stages and the sweep run data-parallel (each
spawns its ranks; see :mod:`sept_tpu_torch.cli.common`), featurize and
preprocess run once; a request that cannot run (more devices than are
visible, a batch size they do not divide) raises before the first stage.
"""

from __future__ import annotations

import argparse

from sept_tpu_torch.cli import evaluate, featurize, preprocess, train_baseline, train_cloak
from sept_tpu_torch.cli.common import add_common_args, resolve_world
from sept_tpu_torch.device import resolve_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    p.add_argument("--grl", type=int, default=0)
    p.add_argument("--ratios", type=int, nargs="*", default=[0])
    p.add_argument("--n_speakers", type=int, default=10)
    p.add_argument("--utts_per_speaker", type=int, default=12)
    p.add_argument("--skip_featurize", action="store_true")
    args = p.parse_args(argv)
    resolve_device(args.device)
    resolve_world(args)

    def fwd(extra=()):
        out = []
        skip = ("grl", "ratios", "skip_featurize", "folds", "n_speakers", "utts_per_speaker")
        for k, v in vars(args).items():
            if k in skip or v is None:
                continue
            out += [f"--{k}", str(v)]
        if args.folds:
            out += ["--folds"] + [str(f) for f in args.folds]
        return out + list(extra)

    if not args.skip_featurize:
        print("== featurize ==")
        featurize.main(fwd(["--n_speakers", str(args.n_speakers),
                            "--utts_per_speaker", str(args.utts_per_speaker)]))
    print("== preprocess ==")
    preprocess.main(fwd())
    print("== baseline (emotion) ==")
    train_baseline.main(fwd(["--pred", "emotion", "--adv", "0"]))
    print("== adversary (gender) ==")
    train_baseline.main(fwd(["--pred", "gender", "--adv", "1"]))
    print("== cloak ==")
    train_cloak.main(fwd(["--grl", str(args.grl)]))
    for ratio in args.ratios:
        if ratio == 0:
            continue
        print(f"== cloak suppression {ratio} ==")
        train_cloak.main(fwd(["--grl", str(args.grl), "--suppression_ratio", str(ratio)]))
    print("== evaluation sweep ==")
    evaluate.main(fwd(["--grl", str(args.grl), "--ratios"] + [str(r) for r in args.ratios]))


if __name__ == "__main__":
    main()
