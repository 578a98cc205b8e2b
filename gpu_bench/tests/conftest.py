"""Tests of the benchmark harness.  ``card`` marks a test that needs the
card; it decides inside itself and skips without one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
