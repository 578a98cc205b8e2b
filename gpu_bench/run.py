"""Run one cell of the benchmark of ``sept_tpu_torch`` on this machine's card.

    python3 gpu_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell is ``BENCHMARK.json``'s workload
entry; its configuration, traffic, limits and metric readers are files
under ``gpu_bench/`` found by name (``harness/cell.py``).  The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its per-layer
metrics with ``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown``,
and last ``checks``: each number that decided ``correct`` beside its limit,
also printed as the last lines of standard error.

It exits non-zero and prints no result without a card (or with fewer than
the cell asks for), without the program beside it, or if JAX or the JAX
package was loaded in this process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sept_tpu")


def loaded_forbidden() -> list:
    """Top-level module names of JAX or the JAX package loaded here,
    compared whole (``sept_tpu_torch`` is not ``sept_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def fail(msg: str, code: int = 2):
    print(f"gpu_bench: {msg}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "sept_tpu_torch").is_dir() or not (ROOT / "BENCHMARK.json").is_file():
        fail(f"no sept_tpu_torch package or BENCHMARK.json under {ROOT}")
    sys.path.insert(0, str(ROOT))
    # a library the port uses must not pull JAX in behind it
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    from gpu_bench.harness import cell as C

    cell = C.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this benchmark measures a card")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} cards, {torch.cuda.device_count()} found")

    rec = C.driver(cell).run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = loaded_forbidden()
    if found:
        fail(f"JAX or the JAX package was loaded in the process: {found}", 3)
    print_result(cell, rec, bool(args.trace))


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def result(cell, rec, trace: bool) -> dict:
    import torch

    from gpu_bench.harness import cell as C

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": rec.memory_peak_bytes, "power_limit": power_limit()}
    out = {"correct": rec.correct, "attempted": rec.attempted, "failed": rec.failed,
           "metrics": C.read_metrics(cell, rec, trace), "device": device}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        out["breakdown"] = {"device_ops": rec.trace.top_ops, "idle_gaps": rec.trace.idle_gaps}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in rec.checks.items()}
    return out


def print_result(cell, rec, trace: bool) -> None:
    out = result(cell, rec, trace)
    for k, v in rec.extra.items():
        print(f"{k}: {json.dumps(v)}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
