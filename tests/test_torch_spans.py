"""The training step's profiler spans (``sept_tpu_torch.utils.span``) on the
CPU at a tiny size: outside a session ``span`` is one shared no-op; inside
one, an epoch of each runner records one ``train.step`` a batch, each
holding one ``train.forward``, ``train.backward`` and ``train.optimizer``
by interval on its thread; and the session changes no number the step
computes: losses, parameters, optimizer state and the generator's state
come out bit-identical with and without it."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sept_tpu_torch.models import CloakedModel, CloakedModelGRL, Conv2dBiRNN
from sept_tpu_torch.train.config import ExperimentConfig
from sept_tpu_torch.train.optim import make_cloak_optimizer, make_optimizer
from sept_tpu_torch.train.steps import (init_state, make_cloak_epoch_runner,
                                        make_epoch_runner)
from sept_tpu_torch.utils import profiling, span

H, WIN, D, B, N_BATCHES = 8, 40, 16, 8, 3
PHASES = ("train.forward", "train.backward", "train.optimizer")
# name -> the cloak runner's keyword arguments; None: the baseline runner
RUNNERS = {
    "baseline": None,
    "cloak": dict(scale_lambda=0.1, grl=False),
    "grl": dict(scale_lambda=0.1, gender_lambda=0.1, grl=True),
    "grl_antithetic_saliency": dict(scale_lambda=0.1, gender_lambda=0.1, grl=True,
                                    antithetic=True, saliency_align=0.5),
}


def _backbone(pred, seed):
    torch.manual_seed(seed)
    return Conv2dBiRNN(H, D, pred, dropout_rate=0.2)


def _run_epoch(kind):
    """(state, losses) after one epoch of ``kind``'s runner from fixed
    weights, data and generator seed."""
    cfg = ExperimentConfig(optimizer="sgd", learning_rate=1e-2, momentum=0.9,
                           weight_decay=1e-4, win_len=WIN, feature_len=D, hidden_size=H,
                           batch_size=B)
    g = torch.Generator().manual_seed(11)
    n = N_BATCHES * B
    windows = torch.randn((n, WIN, D), generator=g)
    le = torch.randint(0, 4, (n,), generator=g)
    lg = torch.randint(0, 2, (n,), generator=g)
    weights = torch.ones(n)
    order = torch.randperm(n, generator=g)
    kw = RUNNERS[kind]
    if kw is None:
        model = _backbone("emotion", 0)
        state = init_state(model, make_optimizer(cfg, N_BATCHES, model), 5, "cpu")
        _, losses, _, _ = make_epoch_runner()(state, windows, le, weights, order,
                                              n_batches=N_BATCHES, batch_size=B)
        return state, losses
    if kw["grl"]:
        model = CloakedModelGRL(_backbone("emotion", 0), _backbone("gender", 1),
                                grl_lambda=0.1, win_len=WIN, n_feats=D)
        prefixes = ("noise", "gender_backbone")
    else:
        model = CloakedModel(_backbone("emotion", 0), win_len=WIN, n_feats=D)
        prefixes = ("noise",)
    state = init_state(model, make_cloak_optimizer(cfg, N_BATCHES, model, prefixes), 5, "cpu")
    _, losses, _, _ = make_cloak_epoch_runner(**kw)(state, windows, le, lg, weights, order,
                                                    None, n_batches=N_BATCHES, batch_size=B)
    return state, losses


def _ranges(prof, names):
    """(start ns, end ns, thread) of every host event named in ``names``."""
    out = {n: [] for n in names}
    for e in prof.profiler.kineto_results.events():
        if e.name() in out and e.device_type() != torch.autograd.DeviceType.CUDA:
            out[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns(),
                                  e.start_thread_id()))
    return out


def test_span_outside_a_session_is_one_shared_noop():
    assert not torch._C._autograd._profiler_enabled()
    a, b = span("train.step"), span("train.forward")
    assert a is b is profiling._NO_SPAN
    assert isinstance(a, contextlib.nullcontext)
    with a as got, b:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pass
    assert not _ranges(prof, ["train.step"])["train.step"]


def test_span_inside_a_session_records_one_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ctx = span("unit.outer")
        assert ctx is not profiling._NO_SPAN
        with ctx:
            with span("unit.inner"):
                torch.ones(4).sum()
    got = _ranges(prof, ["unit.outer", "unit.inner"])
    assert len(got["unit.outer"]) == len(got["unit.inner"]) == 1
    (o0, o1, ot), (i0, i1, it) = got["unit.outer"][0], got["unit.inner"][0]
    assert o0 <= i0 <= i1 <= o1 and ot == it
    assert span("unit.after") is profiling._NO_SPAN


@pytest.mark.parametrize("kind", list(RUNNERS))
def test_each_step_holds_one_span_of_each_phase(kind):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_epoch(kind)
    got = _ranges(prof, ("train.step",) + PHASES)
    steps = sorted(got["train.step"])
    assert len(steps) == N_BATCHES
    for phase in PHASES:
        assert len(got[phase]) == N_BATCHES, phase
    for s0, s1, thread in steps:
        inside = [sorted((a, b) for a, b, t in got[p] if s0 <= a and b <= s1 and t == thread)
                  for p in PHASES]
        assert [len(x) for x in inside] == [1, 1, 1]
        (f0, f1), (b0, b1), (p0, p1) = (x[0] for x in inside)
        assert f1 <= b0 and b1 <= p0  # forward, then backward, then the optimizer


@pytest.mark.parametrize("kind", list(RUNNERS))
def test_a_session_changes_no_number(kind):
    plain, plain_losses = _run_epoch(kind)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, traced_losses = _run_epoch(kind)
    assert torch.equal(plain_losses, traced_losses)
    assert torch.equal(plain.generator.get_state(), traced.generator.get_state())
    assert plain.step == traced.step == N_BATCHES
    ours, theirs = plain.model.state_dict(), traced.model.state_dict()
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    bufs = [plain.optimizer.torch_opt.state[p]["momentum_buffer"]
            for p in plain.optimizer.torch_opt.param_groups[0]["params"]]
    tbufs = [traced.optimizer.torch_opt.state[p]["momentum_buffer"]
             for p in traced.optimizer.torch_opt.param_groups[0]["params"]]
    assert len(bufs) == len(tbufs) > 0
    for x, y in zip(bufs, tbufs):
        assert torch.equal(x, y)
