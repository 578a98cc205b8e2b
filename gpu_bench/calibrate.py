"""Readings that the limits of ``correct`` are set from, at a cell's own
size on this machine's card (or ``--device cpu``):

    python3 gpu_bench/calibrate.py --workload NAME --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3]

For each seed the set-up and the checked steps of a run (the program's
readings against the reference), the control (the reference in the
precision below the cell's: TF32 for float32, float8 for bf16, against the
reference), and each training fault of ``harness/faults.py`` but the
unchanged state (which reads 1 on every leaf by construction).  One JSON
line each.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from gpu_bench.harness import cell as C

    train(C.load_cell(ROOT, args.workload), args)


def _emit(**kw):
    print(json.dumps(kw), flush=True)


def train(cell, args) -> None:
    import torch

    from gpu_bench.drivers import train as train_job
    from gpu_bench.harness import faults

    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        setup = train_job.Setup(cell, seed, args.device)
        prog = setup.first_steps()
        ref = setup.reference()
        if seed in args.seeds:
            worst = {}
            _emit(kind="program", seed=seed, **train_job.compare(prog, ref, worst), worst=worst,
                  losses=prog["losses"], ref_losses=ref["losses"])
        if seed in args.control_seeds:
            worst = {}
            _emit(kind="control", seed=seed,
                  **train_job.compare(setup.reference(control=True), ref, worst), worst=worst)
        del setup
        if args.device == "cuda":
            torch.cuda.empty_cache()
    for name, fault in faults.TRAINING.items():
        if name == "state_unchanged":
            continue
        for seed in args.fault_seeds:
            setup = train_job.Setup(cell, seed, args.device, tamper=fault)
            prog = setup.first_steps()
            worst = {}
            _emit(kind=f"fault_{name}", seed=seed,
                  **train_job.compare(prog, setup.reference(), worst), worst=worst)
            del setup


if __name__ == "__main__":
    main()
