"""Profiling hooks: a profiler trace of a block, named spans inside it, and a
per-step wall timer.

Counterpart of ``sept_tpu/utils/profiling.py``:

- :func:`trace` wraps a block in a ``torch.profiler`` session (host
  activity, and the card's kernels and copies when a card is present) and
  writes a TensorBoard-loadable ``*.pt.trace.json`` into a directory;
- :func:`span` names a phase of the program in whatever ``torch.profiler``
  session is open (:func:`trace`'s or a caller's own), and costs one check
  when none is;
- :class:`StepTimer` measures per-step wall time, reporting n, mean, p50,
  p90 and total.  With a CUDA device it synchronizes that device on enter
  and on exit, so each sample is the step's whole time on the card, not its
  enqueue (the JAX package asks its caller for ``jax.block_until_ready``
  instead).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["trace", "span", "StepTimer"]

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, enabled: bool = True):
    """``with trace('/tmp/profile'): run_steps()`` writes one trace of the
    block into ``log_dir`` (``tensorboard_trace_handler``: no tensorboard
    package needed).  A no-op with ``log_dir=None`` or ``enabled=False``.
    Must not be entered while another ``torch.profiler`` session runs."""
    if not enabled or log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def span(name: str):
    """``with span("train.step"): ...`` marks the block as a range named
    ``name`` in the open ``torch.profiler`` session.

    In a trace the range is a host event of the session that records the
    card's kernels and copies, on its clock: ranges nest by time on the
    thread that opened them, and a device operation belongs to the range
    that holds its launch (the runtime call with the same correlation id).
    Outside a session it returns one shared no-op context: the cost is the
    check alone, and nothing is recorded."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


class StepTimer:
    """Collects per-step wall times.

    >>> timer = StepTimer(device)
    >>> for batch in batches:                       # doctest: +SKIP
    ...     with timer:
    ...         state, m = step(state, batch)
    >>> timer.summary()                             # doctest: +SKIP

    ``device``: a CUDA device is synchronized on enter and on exit; None or
    a CPU device times the host alone."""

    def __init__(self, device=None):
        self.times: list[float] = []
        self._t0: Optional[float] = None
        dev = None if device is None else torch.device(device)
        self._sync = dev if dev is not None and dev.type == "cuda" else None

    def __enter__(self):
        if self._sync is not None:
            torch.cuda.synchronize(self._sync)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            torch.cuda.synchronize(self._sync)
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self, skip_warmup: int = 1) -> dict:
        """n, mean, p50, p90 and total seconds of the samples after the first
        ``skip_warmup``; of the warm-up samples when those are the only ones
        (``n`` says how many back the numbers), zeros when there are none."""
        ts = np.asarray(self.times[skip_warmup:] or self.times)
        if len(ts) == 0:
            return {"n": 0, "mean_s": 0.0, "p50_s": 0.0, "p90_s": 0.0, "total_s": 0.0}
        return {
            "n": int(len(ts)),
            "mean_s": float(ts.mean()),
            "p50_s": float(np.percentile(ts, 50)),
            "p90_s": float(np.percentile(ts, 90)),
            "total_s": float(ts.sum()),
        }
