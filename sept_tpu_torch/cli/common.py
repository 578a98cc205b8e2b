"""Shared CLI plumbing: argparse <-> ExperimentConfig, seeding, the device.

Counterpart of ``sept_tpu/cli/common.py``.  The flags are the JAX CLIs',
less ``--prng_impl``, ``--conv_backend`` and ``--remat`` (the port's config
has no such fields: one block-1 path, torch's generators, no remat), plus
``--device``: every entry point runs on the card unless asked for the CPU.
Data parallelism is not ported (ROADMAP.md §1 item 9): ``--n_devices``
above 1, or a multi-host ``SEPT_COORDINATOR`` in the environment, raises
``NotImplementedError`` instead of training on one card.
"""

from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from sept_tpu_torch.train.config import ExperimentConfig

__all__ = ["add_common_args", "add_device_arg", "config_from_args", "require_one_device",
           "setup_seed"]


def setup_seed(seed: int = 8) -> None:
    """Seed numpy's, ``random``'s and torch's global generators (the
    reference's setup_seed(8), utils/training_tools.py:69-74); the port's
    own draws take explicit generators."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def require_one_device(args) -> None:
    """Refuse a data-parallel request: ``--n_devices`` above 1 or a set
    ``SEPT_COORDINATOR`` (the JAX CLIs' multi-host launch)."""
    if args.n_devices > 1 or os.environ.get("SEPT_COORDINATOR"):
        raise NotImplementedError(
            f"data parallelism (--n_devices {args.n_devices}, SEPT_COORDINATOR="
            f"{os.environ.get('SEPT_COORDINATOR')!r}) is not ported yet "
            "(ROADMAP.md §1 item 9); the port trains on one device")


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device of every stage: 'cuda' (the card, the "
                        "default; raises without one) or 'cpu'")


def add_common_args(p: argparse.ArgumentParser) -> None:
    """Flags mirroring the reference scripts' shared argparse surface
    (training_cloak.py:193-218)."""
    p.add_argument("--dataset", default="iemocap",
                   help="iemocap | crema-d | msp-improv | msp-podcast | synthetic | "
                        "synthetic_hard | combine | combine_two")
    p.add_argument("--corpus_root", default=None,
                   help="corpus root dir (required for real corpora)")
    p.add_argument("--feature_type", default="mel_spec")
    p.add_argument("--input_spec_size", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_epochs", type=int, default=None,
                   help="epochs per fold (default 30; the baseline trainer "
                        "mirrors the reference's 100 under SGD, "
                        "training_adversary_baselines.py:440; unlike the "
                        "reference an EXPLICIT value is always honored)")
    p.add_argument("--model_type", default="2d-cnn-lstm")
    p.add_argument("--pred", default="emotion")
    p.add_argument("--global_feature", type=int, default=0)
    p.add_argument("--norm", default="znorm")
    p.add_argument("--aug", default="emotion")
    p.add_argument("--win_len", type=int, default=200)
    p.add_argument("--shift", type=int, default=1)
    p.add_argument("--optimizer", default="sgd")
    p.add_argument("--learning_rate", type=float, default=None)
    p.add_argument("--att", default=None)
    p.add_argument("--adv", type=int, default=0)
    p.add_argument("--hidden_size", type=int, default=64)
    p.add_argument("--suppression_ratio", type=int, default=0)
    p.add_argument("--scale_lamda", type=float, default=0.0)
    p.add_argument("--grl_lambda", type=float, default=0.1)
    p.add_argument("--gender_lambda", type=float, default=0.1)
    p.add_argument("--antithetic", type=int, default=0,
                   help="antithetic +eps/-eps cloak noise pairs "
                        "(variance-reduced sigma gradients)")
    p.add_argument("--saliency_align", type=float, default=0.0,
                   help="saliency-aligned scale shaping weight for the GRL "
                        "cloak (0 = reference loss)")
    p.add_argument("--mask_direction", choices=("train", "eval"), default="train",
                   help="suppression-mask direction during ratio-matched "
                        "cloak training: 'train' = reference "
                        "(training_cloak.py:364-371, mismatched with the "
                        "eval sweep), 'eval' = the mask the sweep applies")
    p.add_argument("--compute_dtype", choices=("float32", "bfloat16"), default="float32",
                   help="bfloat16 runs blocks 1-3 and the GRU in bf16 (f32 "
                        "parameters, running statistics and sums)")
    p.add_argument("--early_stop_patience", type=int, default=None,
                   help="val-loss early-stopping patience (default: config "
                        "preset; large value disables)")
    p.add_argument("--n_devices", type=int, default=0,
                   help="data-parallel device count: 0 or 1 = one device; "
                        "more is not ported yet and raises")
    p.add_argument("--seed", type=int, default=8)
    p.add_argument("--folds", type=int, nargs="*", default=None,
                   help="1-based fold numbers to run (default: all 5)")
    p.add_argument("--output_dir", default="results")
    p.add_argument("--work_dir", default="work",
                   help="where features/folds are stored")
    add_device_arg(p)


def config_from_args(args, **overrides) -> ExperimentConfig:
    cfg = ExperimentConfig(
        dataset=args.dataset,
        feature_type=args.feature_type,
        feature_len=args.input_spec_size,
        win_len=args.win_len,
        shift=bool(args.shift),
        norm=args.norm,
        aug=args.aug or None,
        adv=bool(args.adv),
        model_type=args.model_type,
        pred=args.pred,
        hidden_size=args.hidden_size,
        att=args.att,
        global_feature=bool(args.global_feature),
        optimizer=args.optimizer,
        batch_size=args.batch_size,
        num_epochs=args.num_epochs if args.num_epochs is not None else 30,
        scale_lambda=args.scale_lamda,
        suppression_ratio=args.suppression_ratio,
        grl_lambda=args.grl_lambda,
        gender_lambda=args.gender_lambda,
        antithetic_noise=bool(args.antithetic),
        saliency_align=float(args.saliency_align),
        mask_direction=args.mask_direction,
        compute_dtype=args.compute_dtype,
        seed=args.seed,
        output_dir=args.output_dir,
    )
    if args.learning_rate is not None:
        cfg.learning_rate = args.learning_rate
    if args.early_stop_patience is not None:
        cfg.early_stop_patience = args.early_stop_patience
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg
