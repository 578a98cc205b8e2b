"""Device time and device-idle time under the program's spans in a traced
slice.

``sept_tpu_torch`` opens a ``train.step`` span around each training step
and inside it ``train.forward`` (the draws through the loss),
``train.backward`` and ``train.optimizer``
(``sept_tpu_torch.utils.profiling.span``).  They are host events of the
profiler session that records the device's operations, on its clock; any
user annotation on the host but the ``gpu_bench.slice`` marker is a span.

The device is idle where no device operation runs inside the marker: the
complement of the busy intervals that
:func:`gpu_bench.harness.trace.summarize` takes, user annotations left out
as it leaves them out.  A phase's idle time is the exact intersection of
those intervals with the union of the phase's spans, with no look-back
limit: a span may hold any number of host events.

A device operation belongs to the spans open at the start of its launch,
the runtime or driver call (``cuda*`` / ``cu*``) with the same correlation
id: to the innermost one alone (``device_self``) and to every one
(``device_under``).  The spans of every thread count, since the autograd
engine launches a backward's operations from threads of its own while the
program's thread waits inside ``train.backward``; the program opens its
spans on one thread, so they nest.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

from gpu_bench.harness.trace import (MARKER, _annotation, _device_op, _events, _item, _ns,
                                     _union)

STEP = "train.step"
PHASES = ("train.forward", "train.backward", "train.optimizer")

__all__ = ["PHASES", "STEP", "Spans", "device_ms_per_step", "reduce_spans"]


@dataclasses.dataclass
class Spans:
    window_s: float  # the slice's wall, as summarize's window_s
    idle_s: float  # device-idle seconds of the slice
    idle_under: dict  # phase -> device-idle seconds under its spans; phases with a span
    steps: int  # train.step spans that start inside the slice
    device_s: float = 0.0  # device operations' seconds in the slice, summed (not their union)
    device_self: dict = dataclasses.field(default_factory=dict)  # innermost span -> seconds
    device_under: dict = dataclasses.field(default_factory=dict)  # any open span -> seconds

    def per_step_ms(self) -> dict:
        """Every reading in milliseconds a step, the count of steps beside."""
        ms = 1e3 / self.steps

        def scaled(d):
            return {k: v * ms for k, v in d.items()}

        return {"steps": self.steps, "wall": self.window_s * ms, "idle": self.idle_s * ms,
                "idle_under": scaled(self.idle_under), "device": self.device_s * ms,
                "device_under": scaled(self.device_under),
                "device_self": scaled(self.device_self)}


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


def _launched(prof, w0: int, w1: int):
    """(device seconds of the slice, {innermost span: seconds}, {span:
    seconds}) of the device operations inside [w0, w1], by the spans open at
    their launch."""
    ops, launch, spans = [], {}, []
    for e in prof.profiler.kineto_results.events():
        if _device_op(e):
            s, t, _, _ = _item(e)
            if t > w0 and s < w1:
                ops.append((min(t, w1) - max(s, w0), e.correlation_id()))
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            pass  # a span's or the marker's range on the device timeline
        elif e.name().startswith("cu"):  # cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...
            launch[e.correlation_id()] = _ns(e, "start")
        elif _annotation(e) and e.name() != MARKER:
            spans.append(_item(e)[:3])
    spans.sort(key=lambda r: (r[0], -r[1]))  # at one start, the outer span first
    starts = [r[0] for r in spans]
    total, inner, under = 0, collections.Counter(), collections.Counter()
    for dur, corr in ops:
        total += dur
        if corr not in launch:
            continue
        at = launch[corr]
        # spans nest: walking back from the latest start, each span still
        # open at the launch holds the ones met before it
        open_ = [r[2] for r in spans[:bisect.bisect_right(starts, at)][::-1] if r[1] > at]
        if open_:
            inner[open_[0]] += dur
            for name in set(open_):
                under[name] += dur
    return (total / 1e9, {k: v / 1e9 for k, v in inner.items()},
            {k: v / 1e9 for k, v in under.items()})


def reduce_spans(prof) -> Spans:
    """The slice's device-idle seconds, their share under each phase's spans,
    the count of steps, and the device seconds by the spans of each
    operation's launch, from the profiler object ``summarize`` reads."""
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
    return Spans((w1 - w0) / 1e9, sum(e - s for s, e in idle) / 1e9, under, steps,
                 *_launched(prof, w0, w1))


def device_ms_per_step(spans: Spans, name: str):
    """Device milliseconds a step launched under the spans ``name``, at any
    depth; None where no span steps were profiled or nothing ran under them."""
    if spans is None or not spans.steps or spans.device_under.get(name, 0.0) <= 0:
        return None
    return 1e3 * spans.device_under[name] / spans.steps
