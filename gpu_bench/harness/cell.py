"""Cells by name: ``BENCHMARK.json``'s entry, its configuration, traffic
and limits files, the driver of its traffic's kind, and the metric readers.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json`` (the path is the entry's ``file``);
- ``traffic/<traffic>.json``: parameters for one general driver,
  ``drivers/<kind>.py``, named by the file's ``kind``;
- ``limits/<workload>.json``: the limit of each number that decides
  ``correct``;
- the configuration's model family: the module that its ``reference`` key
  names below the ``gpu_bench`` package (``reference/<family>.py``,
  ``"reference.<family>"``), ``reference/cnn_bigru.py`` without the key;
- ``metrics/<metric>.py``: ``read(record, cell) -> float | None`` for every
  end-to-end and per-layer metric.  ``None`` leaves the metric out.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parents[1]  # gpu_bench/
DEFAULT_FAMILY = "reference.cnn_bigru"


@dataclasses.dataclass
class Cell:
    workload: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # [(name, unit)] this cell reports with --trace 0
    per_layer: list  # [(name, unit)] with --trace 1
    chips: int = 1


@dataclasses.dataclass
class Record:
    """What a run measured, for the readers."""
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    correct: bool = False
    checks: dict = dataclasses.field(default_factory=dict)  # name -> (value, limit)
    memory_peak_bytes: int = 0
    windows_done: int = 0
    # traced slice, after the window
    trace: Optional[object] = None  # trace.Summary
    slice_steps: int = 0
    launches: dict = dataclasses.field(default_factory=dict)  # kernel counter -> launches
    # the program's eager steps, profiled after the slice
    spans: Optional[object] = None  # spans.Spans
    extra: dict = dataclasses.field(default_factory=dict)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(root: Path, workload: str) -> Cell:
    """``BENCHMARK.json``'s cell ``workload`` with its metrics, from its
    files: the configuration, ``traffic/<traffic>.json`` and
    ``limits/<workload>.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [(m["name"], m["unit"]) for m in bench["end_to_end"] if _applies(m, workload)]
    layer = [(m["name"], m["unit"]) for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(workload, json.loads((root / conf["file"]).read_text()),
                json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
                json.loads((HERE / "limits" / f"{workload}.json").read_text()),
                e2e, layer, entry["chips"])


def family(config: dict):
    """The model family's module of a configuration (``reference/cnn_bigru.py``
    documents what it provides)."""
    return importlib.import_module(f"gpu_bench.{config.get('reference', DEFAULT_FAMILY)}")


def driver(cell: Cell):
    """``drivers/<kind>.py`` of the cell's traffic."""
    return importlib.import_module(f"gpu_bench.drivers.{cell.traffic['kind']}")


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"gpu_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(cell: Cell, rec: Record, trace: bool) -> dict:
    out = {}
    for name, unit in (cell.per_layer if trace else cell.end_to_end):
        value = reader(name)(rec, cell)
        if value is not None:
            out[name] = {"value": float(value), "unit": unit}
    return out
