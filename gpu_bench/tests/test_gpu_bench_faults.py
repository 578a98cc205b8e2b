"""``correct`` comes out false when the timed path is broken underneath,
and the control (the reference in the precision below the cell's) fails
the cell's limits.  The runs skip the harness's look for a card and drive
the rest of a run on the CPU at a tiny size."""

import time

import pytest

from gpu_bench.drivers import train as train_job
from gpu_bench.harness import faults
from tiny import train_cell, train_workloads

TRAIN = train_workloads()


@pytest.mark.parametrize("workload", TRAIN)
def test_sound_training_run_is_correct(workload):
    rec = train_job.run(train_cell(workload), 2**31 + 7, 0.1, False, "cpu", time.perf_counter())
    assert rec.correct, rec.checks


@pytest.mark.parametrize("fault", list(faults.TRAINING.values()), ids=list(faults.TRAINING))
@pytest.mark.parametrize("workload", TRAIN)
def test_training_fault_is_not_correct(workload, fault):
    rec = train_job.run(train_cell(workload), 2**31 + 7, 0.1, False, "cpu", time.perf_counter(),
                        tamper=fault)
    assert not rec.correct, rec.checks


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("workload", TRAIN)
def test_control_fails_a_limit(workload, seed):
    cell = train_cell(workload)
    setup = train_job.Setup(cell, seed, "cpu")
    setup.first_steps()
    got = train_job.compare(setup.reference(control=True), setup.reference())
    assert any(got[k] > cell.limits[k] for k in got), got


@pytest.mark.parametrize("workload", TRAIN)
def test_traced_slice_follows_the_window(workload):
    cell = train_cell(workload)
    rec = train_job.run(cell, 2**31 + 9, 0.0, True, "cpu", time.perf_counter())
    n_train, bs = cell.traffic["train_windows"], cell.traffic["batch_size"]
    assert rec.correct and rec.trace is not None and rec.slice_steps == 2
    assert rec.windows_done == len(rec.extra["epoch_s"]) * n_train
    assert rec.attempted == rec.windows_done // bs + rec.slice_steps
