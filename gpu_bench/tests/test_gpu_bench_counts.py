"""The benchmark's FLOP counts, through the model family's module, against
the per-layer sum from the published shapes, and the bounds' arithmetic."""

import json

import pytest

from gpu_bench.harness import counts
from gpu_bench.harness.cell import family
from tiny import ROOT

CFG = json.loads((ROOT / "gpu_bench" / "configs" / "cnn_bigru_ser.json").read_text())
GRL = json.loads((ROOT / "gpu_bench" / "configs" / "cloak_grl.json").read_text())


def test_forward_flops_of_one_window():
    fam = family(CFG)
    layers = fam.layer_flops(CFG)
    # conv: 2 * H * W * C_out * C_in * 25 on (200, 128), (100, 64), (50, 32)
    assert layers["block1"] == 2 * 200 * 128 * 32 * 1 * 25 == 40_960_000
    assert layers["block2"] == 2 * 100 * 64 * 64 * 32 * 25 == 655_360_000
    assert layers["block3"] == 2 * 50 * 32 * 128 * 64 * 25 == 655_360_000
    # GRU: 2 directions x 25 steps x 3 gates x 64 x (input + 64)
    assert layers["gru1"] == 2 * 2 * 25 * 3 * 64 * (16 * 128 + 64) == 40_550_400
    assert layers["gru2"] == 2 * 2 * 25 * 3 * 64 * (128 + 64) == 3_686_400
    assert layers["heads"] == 2 * (128 * 128 + 128 * 4)
    assert fam.forward_flops(CFG) == pytest.approx(1.3960e9, rel=1e-4)


def test_step_flops():
    fam = family(CFG)
    assert family(GRL) is fam
    f = fam.forward_flops(CFG)
    assert fam.train_flops_per_window(CFG) == pytest.approx(3 * f - 40.96e6)
    assert fam.train_flops_per_window(CFG) == pytest.approx(4.147e9, rel=1e-3)
    assert fam.train_flops_per_window(GRL) == pytest.approx(5 * f)
    assert fam.train_flops_per_window(GRL) == pytest.approx(6.980e9, rel=1e-3)


def test_bounds():
    assert counts.bound(67e12, 0) == pytest.approx(1.0)
    assert counts.bound(0, 3.35e12) == pytest.approx(1.0)
    for k in counts.BLOCK1_KERNELS:
        f32 = counts.block1_bound(k, 32, 32, 200, 128, "float32")
        bf16 = counts.block1_bound(k, 32, 32, 200, 128, "bfloat16")
        assert 0 < bf16 < f32 < 1e-3
