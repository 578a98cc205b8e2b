"""The plain reference against sept_tpu_torch on the CPU at a tiny size:
the checked training steps of both training configurations.  The test
imports both; the reference imports nothing of the program."""

import pytest

from gpu_bench.drivers import train as train_job
from tiny import train_cell


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_reference_follows_the_program_steps(seed):
    setup = train_job.Setup(train_cell("grl_train_f32"), seed, "cpu")
    got = train_job.compare(setup.first_steps(), setup.reference())
    # float32 on both sides; the GRL game's noise gradient takes first-max
    # routing through the pools, where a near tie can route another way
    assert got["loss_gap"] < 1e-6
    assert got["grad_gap"] < 1e-3 and got["change_gap"] < 1e-3


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_bf16_reference_follows_the_program_steps(seed):
    setup = train_job.Setup(train_cell("ser_train_bf16"), seed, "cpu")
    got = train_job.compare(setup.first_steps(), setup.reference())
    # bf16 on both sides, summed in other orders: a sum that lands next to a
    # rounding boundary rounds the other way, one bf16 unit (2^-8 relative)
    assert got["loss_gap"] < 1e-3
    assert got["grad_gap"] < 0.1 and got["change_gap"] < 0.1
