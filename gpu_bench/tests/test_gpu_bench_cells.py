"""BENCHMARK.json's cells resolve to their files by name, and the file
keeps to the benchmark's contract."""

import json
import re

import pytest

from gpu_bench.harness import cell as C
from tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_names():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["gpu_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_finds_its_files(workload):
    cell = C.load_cell(ROOT, workload)
    assert (C.HERE / "drivers" / f"{cell.traffic['kind']}.py").is_file()
    assert callable(C.driver(cell).run)
    for name, _ in cell.end_to_end + cell.per_layer:
        assert callable(C.reader(name))
    assert any(n != "setup_s" for n, _ in cell.end_to_end)
    assert cell.per_layer
    assert set(cell.limits) >= {"loss_gap", "grad_gap", "change_gap"}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    """Each configuration keeps its family's published widths but the keys
    it lists in ``reduced``."""
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    published = C.family(data).PUBLISHED
    for key, value in published.items():
        assert key in config["reduced"] or data[key] == value, key


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "gpu_bench" / "metrics" / f"{m['name']}.py").is_file(), m["name"]
