"""Cells of the benchmark cut to a size the CPU runs in seconds: the same
files, with the widths (the family module's ``TINY``) and the traffic
shrunk."""

import json
from pathlib import Path

from gpu_bench.harness import cell as C

ROOT = Path(__file__).resolve().parents[2]


def train_workloads() -> list:
    """The training cells BENCHMARK.json lists."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


def train_cell(workload: str):
    c = C.load_cell(ROOT, workload)
    c.config.update(C.family(c.config).TINY)
    c.traffic.update(batch_size=8, train_windows=64, val_windows=32, utterance_s=0.63,
                     speakers=5, trace_steps=2, span_steps=2)
    return c
