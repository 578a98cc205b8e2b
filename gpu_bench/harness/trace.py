"""Reduction of a ``torch.profiler`` trace to what the readers and the
result line take: device busy time, device operations by name, launches,
and the longest idle gaps of the device by what the host was doing.

The traced window is the span of a ``record_function`` marker that the
driver opens around its slice; every device operation (kernel, copy, set)
inside it counts, and busy time is the union of their intervals.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

import torch

MARKER = "gpu_bench.slice"

__all__ = ["MARKER", "Summary", "summarize"]


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: int
    time_by_name: dict  # device operation name -> seconds
    top_ops: list  # [[name, seconds]], at most 10
    idle_gaps: list  # [[host op, seconds]], at most 10

    def time_matching(self, pred) -> float:
        return sum(s for n, s in self.time_by_name.items() if pred(n))


def _ns(evt, what):
    if hasattr(evt, f"{what}_ns"):
        return getattr(evt, f"{what}_ns")()
    return getattr(evt, f"{what}_us")() * 1000


def _annotation(evt) -> bool:
    return getattr(evt, "is_user_annotation", lambda: False)()


def _device_op(evt) -> bool:
    """A kernel, copy or set on the device; the marker's own range and the
    spans' ranges show on the device timeline too, as annotations."""
    return (evt.device_type() == torch.autograd.DeviceType.CUDA and evt.name() != MARKER
            and not _annotation(evt))


def _item(evt):
    """(start ns, end ns, name, thread)."""
    start = _ns(evt, "start")
    return (start, start + _ns(evt, "duration"), evt.name(),
            getattr(evt, "start_thread_id", lambda: 0)())


def _events(prof):
    """(device events, host events) as (start ns, end ns, name, thread)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        if _device_op(e):
            dev.append(_item(e))
        elif e.device_type() != torch.autograd.DeviceType.CUDA:
            host.append(_item(e))
    return dev, host


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof) -> Summary:
    dev, host = _events(prof)
    marks = [h for h in host if h[2] == MARKER]
    if marks:
        w0, w1 = min(m[0] for m in marks), max(m[1] for m in marks)
    elif dev:
        w0, w1 = min(d[0] for d in dev), max(d[1] for d in dev)
    else:
        return Summary(0.0, 0.0, 0, {}, [], [])
    inside = [(max(s, w0), min(e, w1), n) for s, e, n, _ in dev if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in inside])
    busy_ns = sum(e - s for s, e in busy)
    by_name = collections.Counter()
    for s, e, n in inside:
        by_name[n] += (e - s) / 1e9
    top = [[n[:120], t] for n, t in by_name.most_common(10)]

    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    ops = sorted(h for h in host if h[2] != MARKER)
    starts = [h[0] for h in ops]
    by_host = collections.Counter()
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        # the innermost host operation running at the gap's middle: the
        # latest-starting one that has not ended (a bounded look back)
        name = "no traced host op"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 256, -1), -1):
            if ops[j][1] >= mid:
                name = ops[j][2]
                break
        by_host[name[:120]] += (g1 - g0) / 1e9
    idle = [[n, t] for n, t in by_host.most_common(10)]
    return Summary((w1 - w0) / 1e9, busy_ns / 1e9, len(inside), dict(by_name), top, idle)
