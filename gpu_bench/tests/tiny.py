"""Cells of the benchmark cut to a size the CPU runs in seconds: the same
files, with the widths and the traffic shrunk."""

import json
from pathlib import Path

from gpu_bench.harness import cell as C

ROOT = Path(__file__).resolve().parents[2]
SHAPES = dict(hidden_size=8, feature_len=32, win_len=48, shift_len=12)
# cells whose configuration, traffic and limits files are kept, ready to be
# listed again, though BENCHMARK.json does not list them: name -> (config, traffic)
UNLISTED = {"ser_train_bf16": ("cnn_bigru_ser", "train_bf16")}


def _unlisted_cell(workload: str):
    config, traffic = UNLISTED[workload]
    return C.Cell(workload, json.loads((C.HERE / "configs" / f"{config}.json").read_text()),
                  json.loads((C.HERE / "traffic" / f"{traffic}.json").read_text()),
                  json.loads((C.HERE / "limits" / f"{workload}.json").read_text()),
                  [("setup_s", "s")], [])


def train_workloads() -> list:
    """The training cells BENCHMARK.json lists, then the unlisted ones."""
    listed = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
    return listed + [w for w in UNLISTED if w not in listed]


def train_cell(workload: str):
    names = {w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]}
    c = C.load_cell(ROOT, workload) if workload in names else _unlisted_cell(workload)
    c.config.update(SHAPES)
    c.traffic.update(batch_size=8, train_windows=64, val_windows=32, utterance_s=0.63,
                     speakers=5, trace_steps=2)
    return c
