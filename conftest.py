"""The CPU thread share of a pytest-xdist worker.

Each of N workers on a box of C cores gets max(1, C // N) threads for
OpenMP and MKL, so that torch (which reads these variables when it first
parallelises) does not start C threads in every worker: N x C spinning
threads on C cores spend most of the run waiting on each other.
Subprocesses and spawned ranks inherit the variables.  A value already set
in the environment stays.  Outside xdist this file does nothing.

Only the environment is touched, and only ``os`` is imported: this file
loads before ``tests/conftest.py``, whose JAX backend set-up must come
first.
"""

import os

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _workers:
    _share = str(max(1, len(os.sched_getaffinity(0)) // int(_workers)))
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(_var, _share)
