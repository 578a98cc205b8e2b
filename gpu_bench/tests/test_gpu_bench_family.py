"""A model family joins the training harness as a module named by its
configuration's ``reference`` key: a tiny run of each listed cell through a
family module under ``tests/`` that records its calls, and the harness's
files that may reach a family only through that module."""

import ast
import importlib
import time

import pytest

from gpu_bench.drivers import train as train_job
from gpu_bench.harness import cell as C
from gpu_bench.harness.trace import Summary
from tiny import ROOT, train_cell, train_workloads

# what the training driver calls of a family, by task; the FLOPs through
# train.step_mfu, the counters in a traced run
COMMON = {"leaves", "init", "backbone_kwargs", "ingest_kwargs", "windows", "pinned_rows",
          "sgd_step", "Draws", "f32_off", "counters", "train_flops_per_window"}
BY_TASK = {"baseline": COMMON | {"baseline_loss"},
           "cloak_grl": COMMON | {"grl_loss", "noise_shape"}}
# keys of the CNN-BiGRU family's configurations, and the files that may
# read them only through the family module
FAMILY_KEYS = {"model_type", "hidden_size", "feature_len", "win_len", "shift_len", "n_fft",
               "channels", "kernel_size", "num_rnn_layers", "dense_size", "dropout_rate"}
GENERIC = ("drivers/train.py", "harness/weights.py", "harness/counts.py",
           "metrics/train.step_mfu.py")


@pytest.mark.parametrize("workload", train_workloads())
def test_a_family_module_found_by_name_drives_the_run(workload, monkeypatch):
    probe = importlib.import_module("gpu_bench.tests.family_probe")
    cell = train_cell(workload)
    cell.config["reference"] = "tests.family_probe"
    # a configuration without the key would find no family
    monkeypatch.setattr(C, "DEFAULT_FAMILY", "reference.no_such_family")
    probe.CALLED.clear()
    rec = train_job.run(cell, 2**31 + 13, 0.0, True, "cpu", time.perf_counter())
    assert rec.correct, rec.checks
    assert rec.spans is not None and rec.spans.steps == 2
    # no device on the CPU: the reader gets a slice that was busy
    rec.trace = Summary(1.0, 0.5, 1, {}, [], [])
    assert C.reader("train.step_mfu")(rec, cell) > 0
    assert probe.CALLED == BY_TASK[cell.config["task"]]


@pytest.mark.parametrize("path", GENERIC)
def test_generic_files_reach_a_family_only_through_its_module(path):
    tree = ast.parse((ROOT / "gpu_bench" / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert not (node.module or "").startswith("gpu_bench.reference"), node.module
        elif isinstance(node, ast.Import):
            assert not any(a.name.startswith("gpu_bench.reference") for a in node.names)
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert node.value not in FAMILY_KEYS, (path, node.value)
