"""The epoch runners' captured training step (``train/steps.py``'s
``_StepGraph``).

On the CPU the runners step eagerly and ``eager_steps`` counts every step;
the rule that decides between an eager step, a capture and a replay is held
case by case on CPU states (a learning-rate change recaptures, a loaded
state, a new batch shape or mask first steps eagerly, an injected epsilon
never engages the graph).

The tests marked ``card`` drive a graphed runner on the H100 for 6 steps
against the eager step closures from one state, at the benchmark's widths:
losses, metrics, parameters and momentum buffers within the benchmark's
limits, the generator's state and the kernels' launch counters (block 1's,
the bf16 GRU's) exactly equal.
They decide inside themselves whether there is a card and skip without one.
On the card: ``python -m pytest tests/test_torch_step_graph.py --noconftest -m card -q``
(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not have).
"""

import contextlib

import pytest
import torch

from sept_tpu_torch.models import CloakedModel, CloakedModelGRL, Conv2dBiRNN
from sept_tpu_torch.train import steps
from sept_tpu_torch.train.config import preset
from sept_tpu_torch.train.optim import (make_cloak_optimizer, make_optimizer,
                                        set_lr_scale)
from sept_tpu_torch.train.steps import (init_state, make_baseline_step,
                                        make_cloak_epoch_runner, make_cloak_grl_step,
                                        make_cloak_step, make_epoch_runner)

# the benchmark's limits (gpu_bench/limits/grl_train_f32.json)
LOSS_GAP, GRAD_GAP, CHANGE_GAP = 2.5e-6, 8e-4, 0.03

# kind -> (model, the runner's and the step's keyword arguments); None: the baseline
KINDS = {
    "grl_f32": ("grl", dict(scale_lambda=0.1, gender_lambda=0.1), torch.float32),
    "baseline_f32": ("baseline", {}, torch.float32),
    "baseline_bf16": ("baseline", {}, torch.bfloat16),
    "cloak_masked": ("cloak", dict(scale_lambda=0.1, apply_scale_reg=False), torch.float32),
    "grl_antithetic": ("grl", dict(scale_lambda=0.1, gender_lambda=0.1, antithetic=True),
                       torch.float32),
}


class Case:
    """One workload at one size: ``state()`` builds the same state every
    call; ``runner()`` a fresh graphed runner; ``eager(state, rows)`` one
    eager step closure call on ``rows``."""

    def __init__(self, kind, device, h, win, d, batch, rows):
        model_kind, kw, dtype = KINDS[kind]
        self.model_kind, self.kw, self.device = model_kind, kw, device
        self.h, self.win, self.d, self.batch, self.dtype = h, win, d, batch, dtype
        g = torch.Generator().manual_seed(17)
        self.windows = torch.randn((rows, win, d), generator=g).to(device)
        self.le = torch.randint(0, 4, (rows,), generator=g).to(device)
        self.lg = torch.randint(0, 2, (rows,), generator=g).to(device)
        self.weights = torch.ones(rows, device=device)
        self.mask = None
        if kind == "cloak_masked":
            self.mask = (torch.rand((win, d), generator=g) > 0.2).float().to(device)
        self.steps_per_epoch = max(1, rows // batch)
        self._weights = self._model().state_dict()

    def _backbone(self, pred, seed):
        torch.manual_seed(seed)
        return Conv2dBiRNN(self.h, self.d, pred, dropout_rate=0.2, compute_dtype=self.dtype)

    def _model(self):
        if self.model_kind == "baseline":
            return self._backbone("emotion", 0)
        if self.model_kind == "grl":
            return CloakedModelGRL(self._backbone("emotion", 0), self._backbone("gender", 1),
                                   grl_lambda=0.1, win_len=self.win, n_feats=self.d)
        return CloakedModel(self._backbone("emotion", 0), win_len=self.win, n_feats=self.d)

    def state(self, optimizer="sgd"):
        model = self._model()
        model.load_state_dict(self._weights)
        spe = self.steps_per_epoch
        if self.model_kind == "baseline":
            opt = make_optimizer(preset("baseline", optimizer=optimizer), spe, model)
        elif self.model_kind == "grl":
            opt = make_cloak_optimizer(preset("cloak_grl", optimizer=optimizer), spe, model,
                                       ("noise", "gender_backbone"))
        else:
            opt = make_cloak_optimizer(preset("cloak", optimizer=optimizer), spe, model,
                                       ("noise",), freeze_rhos=True)
        return init_state(model, opt, 5, self.device)

    def runner(self):
        if self.model_kind == "baseline":
            return make_epoch_runner()
        return make_cloak_epoch_runner(grl=self.model_kind == "grl", **self.kw)

    def run(self, runner, state, rows, eps=None):
        """One runner call over ``rows`` (whole batches): (losses, correct, counts)."""
        n = len(rows) // self.batch
        if self.model_kind == "baseline":
            out = runner(state, self.windows, self.le, self.weights, rows, n_batches=n,
                         batch_size=self.batch)
        else:
            out = runner(state, self.windows, self.le, self.lg, self.weights, rows, self.mask,
                         n_batches=n, batch_size=self.batch, eps=eps)
        return out[1:]

    def step_fn(self):
        if self.model_kind == "baseline":
            return make_baseline_step()
        if self.model_kind == "grl":
            return make_cloak_grl_step(**self.kw)
        return make_cloak_step(**self.kw)

    def eager(self, step, state, rows):
        idx = torch.as_tensor(rows, device=self.device)
        batch = {"spec": self.windows[idx][:, None], "labels_emo": self.le[idx],
                 "labels_gen": self.lg[idx], "weight": self.weights[idx]}
        if self.model_kind == "baseline":
            m = step(state, batch)[1]
        else:
            m = step(state, batch, self.mask)[1]
        return m["loss"], m["correct"], m["count"]


# ---------------------------------------------------------------------------
# CPU: the runners step eagerly


@pytest.mark.parametrize("kind", ["grl_f32", "baseline_f32", "cloak_masked"])
def test_cpu_runner_steps_eagerly_and_counts_every_step(kind):
    case = Case(kind, "cpu", 8, 40, 16, 4, 12)
    rows = torch.randperm(12, generator=torch.Generator().manual_seed(3))
    ours, theirs = case.state(), case.state()
    run = case.runner()
    assert (run.graph_captures, run.graph_replays, run.eager_steps) == (0, 0, 0)
    got = [case.run(run, ours, rows[:4]), case.run(run, ours, rows[4:])]
    step = case.step_fn()
    want = [case.eager(step, theirs, rows[i:i + 4]) for i in range(0, 12, 4)]
    assert (run.graph_captures, run.graph_replays, run.eager_steps) == (0, 0, 3)
    for j in range(3):  # loss, correct, count
        assert torch.equal(torch.cat([got[0][j], got[1][j]]), torch.stack([w[j] for w in want]))
    assert ours.step == theirs.step == ours.optimizer.count == 3
    assert torch.equal(ours.generator.get_state(), theirs.generator.get_state())
    for (k, a), b in zip(ours.model.state_dict().items(), theirs.model.state_dict().values()):
        assert torch.equal(a, b), k


# ---------------------------------------------------------------------------
# CPU: the rule between an eager step, a capture and a replay


def _captured(case, state, inputs):
    """A _StepGraph as after its warm-up step and a capture at the state's
    key and learning rate (the capture itself needs a card)."""
    g = steps._StepGraph()
    key = steps._graph_key(state, case.batch, inputs)
    lr = state.optimizer.lr()
    assert g.plan(key, lr, True) == "eager"  # nothing captured, nothing warm
    g.warm = key
    assert g.plan(key, lr, True) == "capture"
    g.key, g.lr = key, lr
    assert g.plan(key, lr, True) == "replay"
    return g


def _inputs(case, mask="same"):
    return (case.windows, case.le, case.lg, case.weights, None,
            case.mask if mask == "same" else mask)


def _stepped(case):
    """A state after one eager step: SGD holds its momentum buffers."""
    state = case.state()
    case.eager(case.step_fn(), state, list(range(case.batch)))
    return state


def _change_lr(case, state, g):
    set_lr_scale(state.optimizer, 0.5)
    return steps._graph_key(state, case.batch, _inputs(case)), True


def _load_train_state(case, state, g):
    snap = state.snapshot()
    case.eager(case.step_fn(), state, list(range(case.batch, 2 * case.batch)))
    state.load(snap)
    return steps._graph_key(state, case.batch, _inputs(case)), True


def _load_optimizer(case, state, g):
    state.optimizer.load_state_dict(state.optimizer.state_dict())
    return steps._graph_key(state, case.batch, _inputs(case)), True


def _new_batch_shape(case, state, g):
    return steps._graph_key(state, case.batch + 1, _inputs(case)), True


def _short_batch(case, state, g):
    return g.key, False


def _new_mask(case, state, g):
    mask = torch.ones((case.win, case.d))
    return steps._graph_key(state, case.batch, _inputs(case, mask)), True


def _new_windows(case, state, g):
    inputs = (case.windows.clone(),) + _inputs(case)[1:]
    return steps._graph_key(state, case.batch, inputs), True


def _nothing(case, state, g):
    case.eager(case.step_fn(), state, list(range(case.batch)))
    return steps._graph_key(state, case.batch, _inputs(case)), True


# change -> what the next step does
RULES = {
    "nothing_changes": (_nothing, "replay"),
    "learning_rate_recaptures": (_change_lr, "capture"),
    "train_state_load": (_load_train_state, "eager"),
    "optimizer_load_state_dict": (_load_optimizer, "eager"),
    "new_batch_shape": (_new_batch_shape, "eager"),
    "short_batch": (_short_batch, "eager"),
    "new_mask": (_new_mask, "eager"),
    "new_windows": (_new_windows, "eager"),
}


@pytest.mark.parametrize("rule", list(RULES))
def test_what_the_next_step_does(rule):
    case = Case("cloak_masked", "cpu", 8, 40, 16, 4, 12)
    state = _stepped(case)
    g = _captured(case, state, _inputs(case))
    change, want = RULES[rule]
    key, whole = change(case, state, g)
    assert g.plan(key, state.optimizer.lr(), whole) == want


def test_a_loaded_state_is_warmed_then_captured():
    case = Case("grl_f32", "cpu", 8, 40, 16, 4, 12)
    state = _stepped(case)
    g = _captured(case, state, _inputs(case))
    state.optimizer.load_state_dict(state.optimizer.state_dict())
    key = steps._graph_key(state, case.batch, _inputs(case))
    assert g.plan(key, state.optimizer.lr(), True) == "eager"
    case.eager(case.step_fn(), state, list(range(case.batch)))
    g.warm = steps._graph_key(state, case.batch, _inputs(case))
    assert g.warm == key  # the buffers were there: the eager step made none
    assert g.plan(g.warm, state.optimizer.lr(), True) == "capture"


def test_the_first_step_creates_what_the_key_holds():
    case = Case("baseline_f32", "cpu", 8, 40, 16, 4, 12)
    state = case.state()
    before = steps._graph_key(state, case.batch, _inputs(case))
    case.eager(case.step_fn(), state, list(range(case.batch)))
    assert steps._graph_key(state, case.batch, _inputs(case)) != before  # momentum buffers


def test_adam_never_captures():
    case = Case("baseline_f32", "cpu", 8, 40, 16, 4, 12)
    state = case.state(optimizer="adam")
    assert steps._graph_key(state, case.batch, _inputs(case)) is None


@pytest.mark.parametrize("eps", [False, True], ids=["drawn", "injected"])
def test_an_injected_eps_runs_eagerly(monkeypatch, eps):
    case = Case("grl_f32", "cpu", 8, 40, 16, 4, 12)
    seen = []
    real = steps._EpochRunner.steps

    def spy(*args, graphed, **kw):
        seen.append(graphed)
        return real(*args, graphed=graphed, **kw)

    monkeypatch.setattr(steps._EpochRunner, "steps", spy)
    run = case.runner()
    draws = torch.zeros((1, 1, case.win, case.d)) if eps else None
    case.run(run, case.state(), list(range(case.batch)), eps=draws)
    assert seen == [not eps]
    assert run.eager_steps == 1


# ---------------------------------------------------------------------------
# the card: graphed runner against the eager step closures


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _counters():
    return {(f.__name__, a): getattr(f, a) for f, a in steps._launch_counters()}


def _reset_counters():
    for f, a in steps._launch_counters():
        setattr(f, a, 0)


def _momentum(state):
    opt = state.optimizer.torch_opt
    return {n: opt.state[p]["momentum_buffer"] for n, p in state.model.named_parameters()
            if p in opt.state}


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def _agree(case, w0, graphed, eager, got, want):
    """The benchmark's comparison, graphed against eager: each step's
    relative loss gap, each momentum buffer's and each parameter change's
    gap over the larger of its own norm and the median leaf's; metrics,
    steps, counts and the generator's state equal."""
    for j, name in enumerate(("loss", "correct", "count")):
        a, b = torch.stack([x[j] for x in got]), torch.stack([x[j] for x in want])
        if name == "loss":
            assert float(((a - b).abs() / b.abs()).max()) <= LOSS_GAP
        else:
            assert torch.equal(a, b), name
    assert graphed.step == eager.step and graphed.optimizer.count == eager.optimizer.count
    assert torch.equal(graphed.generator.get_state(), eager.generator.get_state())
    mg, me = _momentum(graphed), _momentum(eager)
    assert mg.keys() == me.keys() and mg
    med = sorted(_norm(v) for v in me.values())[len(me) // 2]
    for k in me:
        assert _norm(mg[k] - me[k]) <= GRAD_GAP * max(_norm(me[k]), med), k
    pg, pe = dict(graphed.model.named_parameters()), dict(eager.model.named_parameters())
    change = {k: _norm(pe[k].detach() - w0[k]) for k in pe}
    med = sorted(change[k] for k in me)[len(me) // 2]
    for k in pe:
        assert _norm(pg[k].detach() - pe[k].detach()) <= CHANGE_GAP * max(change[k], med), k
    bg, be = dict(graphed.model.named_buffers()), dict(eager.model.named_buffers())
    for k in be:
        assert torch.allclose(bg[k].double(), be[k].double(), rtol=1e-5, atol=1e-6), k


def _drive(case, calls, between=None, profiled=False):
    """The graphed runner over ``calls`` (steps a call) and the eager step
    closures over the same rows, from one state; ``between(i, state)`` runs
    on both sides before call ``i``.  Returns the runner and each side's
    launch counters after checking that the two agree."""
    rows = torch.randperm(len(case.windows), generator=torch.Generator().manual_seed(4))
    graphed, eager = case.state(), case.state()
    w0 = {k: v.detach().clone() for k, v in graphed.model.named_parameters()}
    run, step = case.runner(), case.step_fn()
    _reset_counters()
    got, at = [], 0
    ctx = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    with ctx as prof:
        for i, n in enumerate(calls):
            if between is not None:
                between(i, graphed)
            out = case.run(run, graphed, rows[at:at + n * case.batch])
            got += list(zip(*out))
            at += n * case.batch
        torch.cuda.synchronize()
    launches_graphed = _counters()
    _reset_counters()
    want, at = [], 0
    for i, n in enumerate(calls):
        if between is not None:
            between(i, eager)
        for _ in range(n):
            want.append(case.eager(step, eager, rows[at:at + case.batch]))
            at += case.batch
    torch.cuda.synchronize()
    assert launches_graphed == _counters()
    _agree(case, w0, graphed, eager, got, want)
    return run, launches_graphed, prof


def _full(kind, device):
    return Case(kind, device, 64, 200, 128, 32, 8 * 32)


@pytest.mark.card
@pytest.mark.parametrize("kind", list(KINDS))
def test_card_graphed_runner_agrees_with_eager_steps(card, kind):
    run, launches, _ = _drive(_full(kind, card), [1, 1, 1, 3])
    assert (run.eager_steps, run.graph_captures, run.graph_replays) == (1, 1, 4)
    assert sum(launches.values()) > 0
    # the bf16 baseline's GRU: one forward and one backward kernel a layer a step
    gru = 2 * 6 if KINDS[kind][2] == torch.bfloat16 else 0
    assert launches[("bigru_lowp", "launches")] == launches[("bigru_lowp", "launches_bwd")] == gru


@pytest.mark.card
def test_card_learning_rate_change_recaptures(card):
    case = _full("grl_f32", card)

    def halve(i, state):
        if i == 3:
            set_lr_scale(state.optimizer, 0.5)

    run, _, _ = _drive(case, [1, 1, 1, 1, 2], between=halve)
    assert (run.eager_steps, run.graph_captures, run.graph_replays) == (1, 2, 3)


@pytest.mark.card
def test_card_steps_after_a_loaded_state_agree(card):
    case = _full("grl_f32", card)
    snaps = {}

    def load(i, state):
        if i == 2:
            snaps[id(state)] = state.snapshot()
        if i == 4:
            state.load(snaps[id(state)])

    run, _, _ = _drive(case, [1, 1, 1, 1, 2], between=load)
    # the load replaces the momentum buffers: one eager step, then a capture
    assert (run.eager_steps, run.graph_captures, run.graph_replays) == (2, 2, 2)


@pytest.mark.card
def test_card_capture_inside_a_profiler_session(card):
    run, _, prof = _drive(_full("grl_f32", card), [1, 1, 1, 3], profiled=True)
    assert (run.eager_steps, run.graph_captures, run.graph_replays) == (1, 1, 4)
    names = {e.name for e in prof.events()}
    assert {"train.step", "train.replay", "train.forward"} <= names
