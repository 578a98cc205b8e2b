"""``harness/spans.py``: the device-idle time under the program's phase
spans and the device time by the spans of each operation's launch, from
hand-made device and host intervals fed through the profiler object's
interface, and from a CPU traced run of each training cell; ``summarize``
reads the same events as it did before the program had spans."""

import time
from types import SimpleNamespace

import pytest
import torch

from gpu_bench.drivers import train as train_job
from gpu_bench.harness.spans import PHASES, STEP, device_ms_per_step, reduce_spans
from gpu_bench.harness.trace import MARKER, summarize
from tiny import train_cell, train_workloads


class _Event:
    """The part of a kineto event that the reductions read."""

    def __init__(self, start, end, name, cuda=False, annotation=False, thread=1,
                 correlation=0):
        self._start, self._end, self._name = start, end, name
        self._cuda, self._annotation, self._thread = cuda, annotation, thread
        self._correlation = correlation

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def name(self):
        return self._name

    def start_thread_id(self):
        return self._thread

    def is_user_annotation(self):
        return self._annotation

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._correlation


def _prof(events):
    results = SimpleNamespace(events=lambda: list(events))
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def _kernel(start, end, name="k"):
    return _Event(start, end, name, cuda=True)


def _host(start, end, name, thread=1):
    return _Event(start, end, name, thread=thread)


def _span(start, end, name, thread=1):
    return _Event(start, end, name, annotation=True, thread=thread)


def _annotated(start, end, name):
    """A host span and its range on the device timeline."""
    return [_span(start, end, name), _Event(start, end, name, cuda=True, annotation=True)]


def _launch(at, correlation, thread=1):
    """A runtime call that launches the device operation of ``correlation``."""
    return _Event(at, at + 5, "cudaLaunchKernel", thread=thread, correlation=correlation)


def _launched(start, end, at, correlation, thread=1):
    return [_Event(start, end, "k", cuda=True, correlation=correlation),
            _launch(at, correlation, thread)]


# a 1,000 ns slice: kernels [100, 200], [300, 600], [800, 900]; idle [0, 100],
# [200, 300], [600, 800], [900, 1000]
STRADDLING = ([_host(0, 1000, MARKER), _Event(0, 1000, MARKER, cuda=True, annotation=True),
               _kernel(100, 200, "conv"), _kernel(300, 600, "gemm"), _kernel(800, 900, "conv"),
               _host(150, 350, "aten::conv"), _host(880, 990, "cudaLaunchKernel")]
              + _annotated(40, 960, STEP)
              + _annotated(50, 250, "train.forward")  # 50 of [0, 100], 50 of [200, 300]
              + _annotated(250, 700, "train.backward")  # 50 + 100
              + _annotated(700, 950, "train.optimizer"))  # 100 + 50


def test_overlaps_of_spans_that_straddle_gaps():
    got = reduce_spans(_prof(STRADDLING))
    assert got.steps == 1
    assert got.window_s == pytest.approx(1000e-9, rel=1e-12)
    assert got.idle_s == pytest.approx(500e-9, rel=1e-12)
    assert got.idle_under == pytest.approx(
        {"train.forward": 100e-9, "train.backward": 150e-9, "train.optimizer": 150e-9},
        rel=1e-12)


def test_nested_and_clipped_spans_count_once():
    events = [_host(1000, 2000, MARKER), _kernel(1200, 1400), _kernel(1700, 1800),
              # two steps, the first begun before the slice: only the second counts
              _host(900, 1450, STEP), _host(1450, 1990, STEP),
              # a forward before the slice and one nested in another
              _host(950, 1100, "train.forward"),
              _host(1500, 1650, "train.forward"), _host(1520, 1600, "train.forward"),
              # a backward past the slice's end
              _host(1750, 2100, "train.backward")]
    got = reduce_spans(_prof(events))
    assert got.steps == 1
    # idle: [1000, 1200], [1400, 1700], [1800, 2000]
    assert got.idle_s == pytest.approx(700e-9, rel=1e-12)
    assert got.idle_under == pytest.approx({"train.forward": 250e-9,
                                            "train.backward": 200e-9}, rel=1e-12)
    assert "train.optimizer" not in got.idle_under


def test_a_span_over_many_host_events_is_not_lost():
    """A backward holding 2,000 host ops around a gap in its middle: the
    overlap is exact, where ``summarize``'s bounded look back names the
    backward for the gaps near its start alone."""
    ops = [_host(10_000 + 400 * i, 10_100 + 400 * i, "aten::mul") for i in range(2_000)]
    kernels = [_kernel(10_000 + 400 * i, 10_390 + 400 * i) for i in range(2_000) if i != 1_000]
    events = ([_host(0, 1_000_000, MARKER), _host(5_000, 900_000, STEP),
               _host(9_000, 820_000, "train.backward")] + ops + kernels)
    got = reduce_spans(_prof(events))
    # idle under the backward: 9,000..10,000 before the first kernel, 10 ns
    # between each of 1,997 pairs, 410 ns around the kernel left out, and
    # 809,990..820,000 after the last
    want = 1_000 + 1_997 * 10 + 410 + 10_010
    assert got.idle_under == pytest.approx({"train.backward": want * 1e-9}, rel=1e-12)
    assert got.idle_s == pytest.approx((1_000_000 - 1_999 * 390) * 1e-9, rel=1e-12)
    assert got.steps == 1
    summary = summarize(_prof(events))
    assert dict(summary.idle_gaps)["train.backward"] < 0.1 * got.idle_under["train.backward"]


def test_device_time_goes_to_the_spans_of_its_launch():
    """Each device operation counts under the innermost span open at its
    launch (``device_self``) and under every open one (``device_under``),
    whichever thread launched it: a span's time is where its operations
    run, not where its host range lies."""
    events = ([_host(0, 10_000, MARKER), _span(0, 10_000, MARKER)]
              # a step holding a forward and a backward; an optimizer that
              # begins at the backward's end, and one inner range inside it
              + [_span(100, 9_000, STEP), _span(200, 3_000, "train.forward"),
                 _span(3_000, 6_000, "train.backward"), _span(6_000, 8_800, "train.optimizer"),
                 _span(6_000, 7_000, "Optimizer.step#SGD.step")]
              # kernels run late, after their launches' spans have ended
              + _launched(1_000, 1_400, 250, 1)  # forward: 400
              + _launched(3_500, 4_500, 2_999, 2)  # forward, at its last ns: 1,000
              + _launched(4_500, 4_600, 3_000, 3)  # backward, from its first ns: 100
              + _launched(7_000, 7_300, 6_000, 4)  # the optimizer's inner range: 300
              + _launched(7_300, 7_500, 8_000, 5)  # the optimizer itself: 200
              + _launched(8_950, 9_100, 8_900, 6)  # the step's own time: 150
              + _launched(9_500, 9_600, 9_200, 7)  # outside any span: 100
              # the autograd engine's thread, in the backward: 300
              + _launched(9_600, 9_900, 4_000, 8, thread=2)
              + _launched(9_900, 10_400, 1_500, 9))  # past the slice's end: 100 inside
    got = reduce_spans(_prof(events))
    assert got.steps == 1
    assert got.device_s == pytest.approx(2_650e-9, rel=1e-12)
    assert got.device_self == pytest.approx(
        {"train.forward": 1_500e-9, "train.backward": 400e-9, "train.optimizer": 200e-9,
         "Optimizer.step#SGD.step": 300e-9, STEP: 150e-9}, rel=1e-12)
    assert got.device_under == pytest.approx(
        {"train.forward": 1_500e-9, "train.backward": 400e-9, "train.optimizer": 500e-9,
         "Optimizer.step#SGD.step": 300e-9, STEP: 2_550e-9}, rel=1e-12)
    assert device_ms_per_step(got, STEP) == pytest.approx(2_550e-6, rel=1e-12)
    assert device_ms_per_step(got, "train.replay") is None
    assert device_ms_per_step(None, STEP) is None


def test_no_device_events_and_no_marker_read_nothing():
    got = reduce_spans(_prof([_host(0, 10, STEP)]))
    assert (got.window_s, got.idle_s, got.idle_under, got.steps) == (0.0, 0.0, {}, 0)


def test_summarize_reads_the_events_as_before():
    """The program's spans and their device-timeline annotations change no
    device time and no count; an idle gap that no aten op covers is named
    after the innermost span running at its middle."""
    got = summarize(_prof(STRADDLING))
    assert got.window_s == pytest.approx(1000e-9, rel=1e-12)
    assert got.busy_s == pytest.approx(500e-9, rel=1e-12)
    assert got.device_ops == 3
    assert got.time_by_name == pytest.approx({"conv": 200e-9, "gemm": 300e-9}, rel=1e-12)
    assert got.top_ops == [["gemm", pytest.approx(300e-9)], ["conv", pytest.approx(200e-9)]]
    assert dict(got.idle_gaps) == pytest.approx(
        {"train.forward": 100e-9, "train.backward": 100e-9, "train.optimizer": 200e-9,
         "cudaLaunchKernel": 100e-9}, rel=1e-12)
    bare = [e for e in STRADDLING if e.name() not in (STEP,) + PHASES]
    without = summarize(_prof(bare))
    assert (without.window_s, without.busy_s, without.device_ops, without.time_by_name,
            without.top_ops) == (got.window_s, got.busy_s, got.device_ops, got.time_by_name,
                                 got.top_ops)
    assert dict(without.idle_gaps) == pytest.approx(
        {"no traced host op": 300e-9, "aten::conv": 100e-9, "cudaLaunchKernel": 100e-9},
        rel=1e-12)


@pytest.mark.parametrize("workload", train_workloads())
def test_span_steps_carry_their_spans(workload):
    """A training cell's traced run profiles its span steps, the library's
    eager step, apart from the slice: one ``train.step`` span a step, every
    device operation launched inside one (none on the CPU), each phase
    present, and the phases' idle within the steps' idle."""
    cell = train_cell(workload)
    rec = train_job.run(cell, 2**31 + 11, 0.0, True, "cpu", time.perf_counter())
    got = rec.spans
    assert rec.correct and got is not None
    assert got.steps == cell.traffic["span_steps"] == 2
    assert got.device_under.get(STEP, 0.0) == got.device_s
    assert set(got.idle_under) == set(PHASES)
    assert 0 < sum(got.idle_under.values()) <= got.idle_s <= got.window_s


@pytest.mark.parametrize("workload", train_workloads())
def test_traced_slice_carries_its_steps(workload, monkeypatch):
    """A training cell's traced slice, reduced as ``summarize`` reduces it: one
    ``train.step`` span a step of the slice, each phase present, and the idle
    time under the phases within the slice's idle time."""
    seen = []

    def summarize_and_reduce(prof):
        seen.append(reduce_spans(prof))
        return summarize(prof)

    monkeypatch.setattr(train_job, "summarize", summarize_and_reduce)
    rec = train_job.run(train_cell(workload), 2**31 + 9, 0.0, True, "cpu", time.perf_counter())
    assert rec.correct and len(seen) == 1
    got = seen[0]
    assert got.steps == rec.slice_steps == 2
    assert set(got.idle_under) == set(PHASES)
    # no device on the CPU: the whole slice is idle, as summarize's window
    assert got.window_s == got.idle_s == pytest.approx(rec.trace.window_s, rel=1e-12)
    assert 0 < sum(got.idle_under.values()) <= got.idle_s
