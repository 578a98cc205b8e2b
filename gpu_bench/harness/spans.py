"""Device-idle time under the program's phase spans in a traced slice.

``sept_tpu_torch`` opens a ``train.step`` span around each training step
and inside it ``train.forward`` (the draws through the loss),
``train.backward`` and ``train.optimizer``
(``sept_tpu_torch.utils.profiling.span``).  They are host events of the
profiler session that records the device's operations, on its clock.

The device is idle where no device operation runs inside the
``gpu_bench.slice`` marker: the complement of the busy intervals that
:func:`gpu_bench.harness.trace.summarize` takes, user annotations left out
as it leaves them out.  A phase's idle time is the exact intersection of
those intervals with the union of the phase's spans, with no look-back
limit: a span may hold any number of host events.
"""

from __future__ import annotations

import dataclasses

from gpu_bench.harness.trace import MARKER, _events, _union

STEP = "train.step"
PHASES = ("train.forward", "train.backward", "train.optimizer")

__all__ = ["PHASES", "STEP", "Spans", "reduce_spans"]


@dataclasses.dataclass
class Spans:
    window_s: float  # the slice's wall, as summarize's window_s
    idle_s: float  # device-idle seconds of the slice
    idle_under: dict  # phase -> device-idle seconds under its spans; phases with a span
    steps: int  # train.step spans that start inside the slice


def _intersect(a, b) -> int:
    """Total length of the overlap of two sorted lists of disjoint intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce_spans(prof) -> Spans:
    """The slice's device-idle seconds, their share under each phase's spans
    and the count of steps, from the profiler object ``summarize`` reads."""
    dev, host = _events(prof)
    marks = [h for h in host if h[2] == MARKER]
    if marks:
        w0, w1 = min(m[0] for m in marks), max(m[1] for m in marks)
    elif dev:
        w0, w1 = min(d[0] for d in dev), max(d[1] for d in dev)
    else:
        return Spans(0.0, 0.0, {}, 0)
    busy = _union([(max(s, w0), min(e, w1)) for s, e, _, _ in dev if e > w0 and s < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    under = {}
    for phase in PHASES:
        got = [(max(s, w0), min(e, w1)) for s, e, n, _ in host
               if n == phase and e > w0 and s < w1]
        if got:
            under[phase] = _intersect(idle, _union(got)) / 1e9
    steps = sum(1 for s, _, n, _ in host if n == STEP and w0 <= s < w1)
    return Spans((w1 - w0) / 1e9, sum(e - s for s, e in idle) / 1e9, under, steps)
