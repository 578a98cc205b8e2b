"""Shared CLI plumbing: argparse <-> ExperimentConfig, seeding, the device,
the data-parallel group.

Counterpart of ``sept_tpu/cli/common.py``.  The flags are the JAX CLIs',
less ``--prng_impl``, ``--conv_backend`` and ``--remat`` (the port's config
has no such fields: one block-1 path, torch's generators, no remat), plus
``--device``: every entry point runs on the card unless asked for the CPU.

Data parallelism (``train_baseline``, ``train_cloak``, ``evaluate``, and
``run_all``, which passes ``--n_devices`` to them) runs one process a
device, each a rank of a process group (:mod:`sept_tpu_torch.parallel`):

- ``--n_devices N`` from one launch spawns N local ranks (the ``spawn``
  start method), rank r on ``cuda:r`` over NCCL; ``--device cpu
  --n_devices N`` spawns N CPU ranks over gloo (the test facility, the
  counterpart of JAX's virtual CPU mesh).  An explicit N above the visible
  devices, or a ``--batch_size`` it does not divide, raises ``SystemExit``;
- ``--n_devices 0`` (auto) takes every visible card on CUDA and 1 on the
  CPU, cut to the largest count that divides ``--batch_size``, so a command
  that worked never starts failing;
- multi-host: each launched process is one rank of the world that
  ``SEPT_COORDINATOR=host:port``, ``SEPT_NUM_PROCESSES`` and
  ``SEPT_PROCESS_ID`` describe (``init_process_group`` over
  ``tcp://host:port``); ``--n_devices`` must then be 0 or the world size,
  and a coordinator without the other two raises ``SystemExit``;
- rank 0 alone writes results, checkpoints, manifests and logs and prints;
  the other ranks wait at a barrier.  The backend is NCCL on CUDA and gloo
  on the CPU, with no fallback from one to the other.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
from typing import Optional

import numpy as np
import torch

from sept_tpu_torch.parallel import (DataGroup, current_group, init_distributed, is_main,
                                     make_group, spawn, visible_devices)
from sept_tpu_torch.train.config import ExperimentConfig

__all__ = ["add_common_args", "add_device_arg", "config_from_args", "printer",
           "resolve_group", "resolve_world", "setup_seed", "spawn_ranks"]


def setup_seed(seed: int = 8) -> None:
    """Seed numpy's, ``random``'s and torch's global generators (the
    reference's setup_seed(8), utils/training_tools.py:69-74); the port's
    own draws take explicit generators."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def _dcn_proc_env() -> tuple[int, int]:
    """(num_processes, process_id) from the multi-host environment.  A set
    ``SEPT_COORDINATOR`` without the other two is a misconfigured launch:
    running every host as a job of its own would duplicate the work and
    clobber the outputs, so it fails with the fix spelled out."""
    try:
        return int(os.environ["SEPT_NUM_PROCESSES"]), int(os.environ["SEPT_PROCESS_ID"])
    except KeyError as e:
        raise SystemExit(
            f"SEPT_COORDINATOR is set but {e.args[0]} is not: a multi-host launch needs "
            "SEPT_COORDINATOR, SEPT_NUM_PROCESSES and SEPT_PROCESS_ID all exported (unset "
            "SEPT_COORDINATOR for a single-process run)") from None


def resolve_world(args) -> int:
    """``--n_devices``, ``--batch_size``, ``--device`` and the ``SEPT_*``
    environment -> the number of ranks of the run (1: one device); see the
    module docstring.  Misuse raises ``SystemExit``."""
    group, coord = current_group(), os.environ.get("SEPT_COORDINATOR")
    if group is not None or coord:
        n = group.world_size if group is not None else _dcn_proc_env()[0]
        if args.n_devices not in (0, n):
            raise SystemExit(f"--n_devices {args.n_devices} but the process group holds "
                             f"{n} ranks (pass 0 or {n})")
    else:
        n = args.n_devices
        cuda = torch.device(args.device).type == "cuda"
        if n == 0:
            n = visible_devices(args.device) if cuda else 1
            while n > 1 and args.batch_size % n:
                n -= 1
        avail = visible_devices(args.device)
        if n > avail:
            raise SystemExit(f"--n_devices {n} but only {avail} {args.device} devices are "
                             "visible")
    if n > 1 and args.batch_size % n:
        raise SystemExit(f"--batch_size {args.batch_size} must be divisible by "
                         f"--n_devices {n}")
    return max(n, 1)


def _run_main(group, main, argv):
    return main(argv)


def spawn_ranks(main, argv, args) -> Optional[list]:
    """Where this process is a single launch and the run needs N > 1 ranks:
    run ``main(argv)`` in N new processes, one a device (:func:`spawn`), and
    return their return values by rank; else None (this process runs alone,
    or is a rank already).  A rank that fails makes this raise its error."""
    if current_group() is not None or os.environ.get("SEPT_COORDINATOR"):
        return None
    n = resolve_world(args)
    if n <= 1:
        return None
    argv = list(sys.argv[1:] if argv is None else argv)
    devices = make_group(n, args.device)
    # CPU ranks share the cores
    threads = 0 if devices[0].type == "cuda" else max(1, visible_devices("cpu") // n)
    return spawn(_run_main, devices, main, argv, threads=threads)


def resolve_group(args) -> Optional[DataGroup]:
    """This process's data-parallel group: the one it is a rank of (spawned
    by :func:`spawn_ranks`, or joined here from the ``SEPT_*``
    environment), or None for one device.  Rank 0 prints the world size."""
    n = resolve_world(args)
    group, coord = current_group(), os.environ.get("SEPT_COORDINATOR")
    if group is None and coord:
        group = init_distributed(coord, *_dcn_proc_env(), device=args.device)
    if group is None and n > 1:
        raise ValueError(f"a {n}-rank run: start its ranks with spawn_ranks first")
    if group is not None and group.rank == 0:
        print(f"data parallel: {group.world_size} ranks over {group.backend}")
    return group


def printer(group: Optional[DataGroup]):
    """``print`` on the process that writes (rank 0, or a run without a
    group), a no-op on the other ranks."""
    return print if is_main(group) else (lambda *a, **k: None)


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
                   help="data-parallel device count: 0 = auto (every visible "
                        "card on CUDA, 1 on the CPU), N = N ranks, one a "
                        "device (--device cpu: N CPU ranks over gloo)")
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
