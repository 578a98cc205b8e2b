"""Train steps and whole-epoch runners of the baseline, cloak and cloak + GRL
workloads.

Counterpart of ``sept_tpu/train/steps.py``; the function names are the JAX
package's.  Losses:

- baseline / adversary: per-sample weighted CE over the real rows (padding
  rows carry weight 0); ``pred="multitask"`` sums the emotion and gender CE;
- cloak: weighted CE - scale_lambda * log(mean(scales));
- cloak + GRL: weighted emotion CE + gender_lambda * gender CE (reversed into
  the noise by the GRL) - scale_lambda * log(mean(scales)) [+ saliency_align
  * :func:`saliency_alignment_loss`], one backward.

Where JAX threads an immutable ``TrainState`` through jitted functions, a
step here updates ``state.model`` and ``state.optimizer`` in place and
returns the same state.  Every random draw (dropout masks, cloak epsilon)
comes from ``state.generator``; a step and an epoch runner also take an
injected ``eps`` (the tests feed the JAX draw that way).  Metrics stay on the
device: an epoch runner stacks its per-batch loss, correct and count tensors,
and the caller reads them once an epoch, as the JAX scan returns them.

The fold drivers (:mod:`sept_tpu_torch.train.device_loop`) keep the best
state as a :meth:`TrainState.snapshot`, a copy: the live state goes on
changing.  :func:`make_eval_logits_fn` is the eval forward of validation,
the test vote and the sweep.

The models carry their own ``compute_dtype`` (``Conv2dBiRNN``): a bf16
model trains through the same steps, with logits, losses and metrics in f32.
Factories switch TF32 off (``sept_tpu_torch.device.f32_precision``).

On a card the epoch runners replay the whole training step as one CUDA
graph (:class:`_StepGraph`): the row gather, the epsilon and dropout draws,
the forward through every backbone, the loss, ``loss.backward()`` and the
SGD update, the same kernels an eager step launches, with the host out from
between them.  A runner's first full batch runs eagerly on the capture
stream (the warm-up: SGD's momentum buffers, cuDNN's and autograd's lazy
state), the next is captured and replayed, and every later one with the
same batch shape, learning rate and tensors is replayed.  It decides from
what it sees: CPU tensors, an injected ``eps``, an optimizer other than
SGD and a short batch run eagerly as before.  The step closures that
:func:`~sept_tpu_torch.train.loop.fit` drives and the data-parallel runners
always run eagerly.  Each runner counts its steps in ``graph_captures``,
``graph_replays`` and ``eager_steps``.

In a ``torch.profiler`` session each training step is a ``train.step``
span (:func:`~sept_tpu_torch.utils.profiling.span`); an eager or captured
step holds ``train.forward`` (the draws through the loss),
``train.backward`` and the optimizer's ``train.optimizer``, a replayed one
``train.replay``.  ``zero_grad`` and the metrics stay in the step's own
time, an eager step's row gather outside it.

``use_global``: the 88-dim global feature goes to the model beside the
windows, ``batch["global"]`` (B, 88) in a step and ``globals_`` (M, 88) in
an epoch runner, rows picked with the windows'.  The model must be built
with ``global_dim=N_GLOBAL`` (its ``dense1`` takes pooled + 88 inputs):
where the JAX package's ``init_state(use_global=...)`` fixes that width at
init, the port fixes it when the model is built.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
from typing import Optional

import torch
from torch import nn

from sept_tpu_torch.device import f32_precision, resolve_device
from sept_tpu_torch.models.backbone import DropoutDraws
from sept_tpu_torch.train.optim import Optimizer
from sept_tpu_torch.utils.profiling import span

__all__ = [
    "TrainState",
    "init_state",
    "weighted_nll_sum",
    "count_real",
    "weighted_ce",
    "make_baseline_step",
    "make_epoch_runner",
    "make_cloak_step",
    "make_cloak_grl_step",
    "make_cloak_epoch_runner",
    "make_eval_logits_fn",
    "cloak_scales",
    "saliency_alignment_loss",
    "baseline_loss",
    "cloak_loss",
    "grl_loss",
    "scale_reg",
]


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0

    def snapshot(self) -> dict:
        """A copy of everything the state carries: the model's state_dict,
        the optimizer's (its update count and plateau scale too), the
        generator's state and the step."""
        return {"model": copy.deepcopy(self.model.state_dict()),
                "optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(), "step": self.step}

    def load(self, snapshot: dict) -> "TrainState":
        """Put the state back where :meth:`snapshot` took it."""
        self.model.load_state_dict(snapshot["model"])
        self.optimizer.load_state_dict(snapshot["optimizer"])
        self.generator.set_state(snapshot["generator"].cpu())
        self.step = int(snapshot["step"])
        return self


def init_state(model: nn.Module, optimizer: Optimizer, seed: int = 0,
               device="cuda") -> TrainState:
    """Move ``model`` to ``device`` (its parameters keep their identity, so
    ``optimizer`` stays bound to them) and seed the state's generator."""
    dev = resolve_device(device)
    f32_precision()
    model.to(dev)
    return TrainState(model, optimizer, torch.Generator(device=dev).manual_seed(seed))


def weighted_nll_sum(logits: torch.Tensor, labels: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Weighted negative-log-likelihood sum (no normalization)."""
    nll = -torch.log_softmax(logits, -1).gather(-1, labels.long()[:, None])[:, 0]
    return (nll * weights).sum()


def count_real(weights: torch.Tensor) -> torch.Tensor:
    """Number of real (non-padding) rows, weights > 0, at least 1."""
    return torch.clamp((weights > 0).sum().to(torch.float32), min=1.0)


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Per-sample weighted CE averaged over the real row count (speaker
    weights scale the numerator only)."""
    return weighted_nll_sum(logits, labels, weights) / count_real(weights)


def _metrics(logits, labels, weights, loss):
    """Accuracy counts are unweighted over real rows."""
    preds = logits.argmax(-1)
    valid = (weights > 0).to(torch.float32)
    return {"loss": loss.detach(), "correct": ((preds == labels) * valid).sum(),
            "count": valid.sum(), "preds": preds}


def _apply(state: TrainState, loss: torch.Tensor) -> None:
    state.optimizer.zero_grad()
    with span("train.backward"):
        loss.backward()
    state.optimizer.step()
    state.step += 1


def _batches(order, n_batches, batch_size, device):
    order = torch.as_tensor(order, dtype=torch.long, device=device)
    for i in range(n_batches):
        yield order[i * batch_size:(i + 1) * batch_size]


def _stack(metrics):
    return tuple(torch.stack([m[k] for m in metrics]) for k in ("loss", "correct", "count"))


def _packed(m):
    """A step's (loss, correct, count) as one (3,) f32 tensor."""
    return torch.stack([m["loss"], m["correct"], m["count"]])


def _launch_counters():
    """The launch counters of the kernels a step runs, block 1's, the bf16
    GRU's and WavLM's attention core's: ``(wrapper, attribute)`` pairs."""
    from sept_tpu_torch.ops import conv_block1 as k
    from sept_tpu_torch.ops.attention import gated_bias_attention
    from sept_tpu_torch.ops.gru_lowp import bigru_lowp

    return [(f, attr) for f in (k.block1_conv_stats, k.block1_norm_pool, k.block1_route,
                                k.block1_weight_grads, k.block1_input_grad)
            for attr in ("launches", "launches_bf16")] + [
        (f, attr) for f in (bigru_lowp, gated_bias_attention)
        for attr in ("launches", "launches_bwd")]


def _tensor_key(t):
    """Where and how a tensor lies: what a captured kernel baked in."""
    return None if t is None else (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())


def _graph_key(state: TrainState, batch_size: int, inputs) -> Optional[tuple]:
    """Everything a captured step bakes in but the learning rate, or None
    where the step cannot be captured (an optimizer other than SGD, whose
    host-side state a replay would not advance): the model, optimizer and
    generator objects, the batch size, the runner's input tensors, every
    parameter (and whether it trains), buffer and optimizer-state tensor,
    and the optimizer's other hyperparameters."""
    opt = state.optimizer.torch_opt
    if type(opt) is not torch.optim.SGD:
        return None
    model = state.model
    return (model, state.optimizer, state.generator, batch_size,
            tuple(_tensor_key(t) for t in inputs),
            tuple((_tensor_key(p), p.requires_grad) for p in model.parameters()),
            tuple(_tensor_key(b) for b in model.buffers()),
            tuple(tuple((k, _tensor_key(v) if torch.is_tensor(v) else v)
                        for k, v in opt.state.get(p, {}).items())
                  for g in opt.param_groups for p in g["params"]),
            tuple(tuple((k, v) for k, v in g.items() if k not in ("params", "lr"))
                  for g in opt.param_groups))


class _StepGraph:
    """One epoch runner's training step as a captured CUDA graph, kept
    across the runner's calls.

    ``update(state, i, idx)`` is the eager step on the rows ``idx`` of the
    runner's inputs (the gather included); it returns the step's metrics.
    The graph captures ``update`` on a static index buffer, with
    ``zero_grad(set_to_none=True)`` before its backward, so the gradients
    live in the graph's memory pool, and with ``state.generator`` registered,
    so that each replay draws what an eager step would and advances the
    generator as far.  A replay is one index copy, the graph and one copy of
    its (loss, correct, count) out; the host advances ``state.step`` and the
    optimizer's count, and adds to block 1's launch counters what the
    capture counted.

    A replay needs the key (:func:`_graph_key`) and the learning rate the
    graph was captured at.  A new learning rate recaptures at once, in the
    same pool; any other change (a loaded optimizer state, a new mask or
    batch shape) first takes one eager step on the capture stream, which
    makes whatever the step creates lazily, and captures at the next."""

    def __init__(self):
        self.graph = None
        self.key = self.lr = None  # what the graph baked in
        self.warm = None  # the key after the last full-batch eager step
        self.stream = self.pool = self.idx = self.packed = None
        self.launches = {}  # the counted kernels' launches a replay

    def plan(self, key, lr, whole: bool) -> str:
        """What a step with ``key`` at ``lr`` does: "replay", "capture" or
        "eager"; ``whole``: the batch has the runner's batch size."""
        if not whole:
            return "eager"
        if key == self.key and lr == self.lr:
            return "replay"
        return "capture" if key == self.warm else "eager"

    def eager(self, state, update, i, idx) -> torch.Tensor:
        """One eager step on the capture stream; its packed metrics."""
        if self.stream is None:
            self.stream = torch.cuda.Stream(idx.device)
        here = torch.cuda.current_stream(idx.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            packed = _packed(update(state, i, idx))
        here.wait_stream(self.stream)
        return packed

    def capture(self, state, update, key, lr, batch_size: int) -> None:
        """Capture ``update`` on the index buffer.  The capture's host side
        advances the state as one step does; its kernels run at the
        replay after it."""
        if self.idx is None or self.idx.shape[0] != batch_size:
            self.idx = torch.empty(batch_size, dtype=torch.long,
                                   device=state.generator.device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        counters = _launch_counters()
        before = [getattr(f, a) for f, a in counters]
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        # no collection inside the capture: garbage that holds another
        # graph would free it there, which the capture does not permit
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                packed = _packed(update(state, None, self.idx))
        finally:
            if collecting:
                gc.enable()
        self.launches = {}
        for (f, a), n in zip(counters, before):
            if getattr(f, a) != n:
                self.launches[f, a] = getattr(f, a) - n
            setattr(f, a, n)
        self.graph, self.packed, self.key, self.lr = graph, packed, key, lr

    def replay(self, state, idx, out, advance: bool = True) -> None:
        """Run the captured step on the rows ``idx``; its metrics into ``out``."""
        self.idx.copy_(idx)
        with span("train.step"), span("train.replay"):
            self.graph.replay()
            out.copy_(self.packed)
        if advance:
            state.step += 1
            state.optimizer.count += 1
        for (f, a), n in self.launches.items():
            setattr(f, a, getattr(f, a) + n)


class _EpochRunner:
    """An epoch runner: ``fn(runner, state, ...)`` with the runner's captured
    step and its counters ``graph_captures``, ``graph_replays`` and
    ``eager_steps``, in the idiom of the kernel wrappers' ``launches``.  A
    class and not a closure, so that a runner (and its graph's memory pool)
    goes with its last reference and never waits for the cyclic garbage
    collector, which could run during another runner's capture."""

    def __init__(self, fn):
        self.fn = fn
        self.graph = _StepGraph()
        self.graph_captures = self.graph_replays = self.eager_steps = 0

    def __call__(self, *args, **kwargs):
        return self.fn(self, *args, **kwargs)

    def steps(self, state: TrainState, update, inputs, order, n_batches: int,
              batch_size: int, graphed: bool):
        """``n_batches`` steps of ``update`` over ``order``: (losses,
        correct, counts).  ``graphed``: replay the captured step where it
        applies (CUDA inputs, an SGD optimizer, a whole batch, the captured
        key and learning rate); else every step is eager, as on the CPU."""
        device = inputs[0].device
        key = (_graph_key(state, batch_size, inputs) if graphed and device.type == "cuda"
               else None)
        if key is None:
            self.eager_steps += n_batches
            return _stack([update(state, i, idx) for i, idx in
                           enumerate(_batches(order, n_batches, batch_size, device))])
        graph = self.graph
        out = torch.empty((3, n_batches), dtype=torch.float32, device=device)
        for i, idx in enumerate(_batches(order, n_batches, batch_size, device)):
            whole = idx.shape[0] == batch_size
            lr = state.optimizer.lr()
            todo = graph.plan(key, lr, whole)
            if todo == "replay":
                graph.replay(state, idx, out[:, i])
                self.graph_replays += 1
            elif todo == "capture":
                graph.capture(state, update, key, lr, batch_size)
                graph.replay(state, idx, out[:, i], advance=False)
                self.graph_captures += 1
            else:
                out[:, i] = graph.eager(state, update, i, idx)
                self.eager_steps += 1
                key = _graph_key(state, batch_size, inputs)
                if whole:
                    graph.warm = key
        return out[0], out[1], out[2]


def cloak_scales(model: nn.Module) -> torch.Tensor:
    """Current noise scales of a cloaked model (tanh squash), (1, win, feats)."""
    return model.noise.scales()


def scale_reg(model, loss, scale_lambda, apply_scale_reg, share: float = 1.0):
    """``loss - scale_lambda * log(mean(scales)) / share`` when the
    regularizer applies: a data-parallel rank adds its 1/world share, so the
    summed gradients carry it once."""
    if apply_scale_reg and scale_lambda:
        return loss - scale_lambda * torch.log(cloak_scales(model).mean()) / share
    return loss


def _input_saliency(backbone: nn.Module, spec, labels, weights, pooling, global_feature=None):
    """|d weighted CE / d x| of ``backbone`` in eval mode with its parameters
    held constant, averaged over the batch and scaled to unit mean: (T, D).
    The parameters go in detached (``functional_call``), so the backward
    computes the input gradient alone: block 1's K3 and K5, never K4."""
    was_training = backbone.training
    backbone.eval()
    try:
        params = {k: v.detach() for k, v in backbone.named_parameters()}
        x = spec.detach().requires_grad_()
        g = None if global_feature is None else global_feature.detach()
        logits = torch.func.functional_call(backbone, params, (x,),
                                            {"pooling": pooling, "global_feature": g})
        (grad,) = torch.autograd.grad(weighted_ce(logits, labels, weights), x)
    finally:
        backbone.train(was_training)
    sal = grad.abs().mean(0)[0]
    return sal / (sal.mean() + 1e-8)


def saliency_alignment_loss(model: nn.Module, spec: torch.Tensor, labels_emo: torch.Tensor,
                            labels_gen: torch.Tensor, weights: torch.Tensor,
                            pooling: Optional[str] = "mean",
                            global_feature: Optional[torch.Tensor] = None) -> torch.Tensor:
    """First-order scale-shaping term of the cloak + GRL game, a framework
    extension of the JAX package (off by default):
    ``mean(scales * (sal_emo - sal_gen))``, where each saliency is the input
    gradient of one branch's weighted CE on ``spec`` (B, 1, T, D), taken in
    eval mode with the current running statistics and scaled to unit mean.
    The saliencies are constants, so the term is linear in the scales and
    its gradient reaches only the noise's ``rhos``: minimizing it moves noise
    onto the cells the gender adversary reads and off the ones the emotion
    model reads.  ``model`` is a ``CloakedModelGRL``; ``global_feature``
    (B, 88), a constant, goes to both backbones."""
    sal = (_input_saliency(model.emotion_backbone, spec, labels_emo, weights, pooling,
                           global_feature)
           - _input_saliency(model.gender_backbone, spec, labels_gen, weights, pooling,
                             global_feature))
    return (cloak_scales(model) * sal).mean()


# ---------------------------------------------------------------------------
# baseline / adversary / multitask


def baseline_loss(model, spec, labels, weights, labels_gen, pooling, g, draws,
                  ce=weighted_ce):
    """(loss, logits) of a train-mode baseline / adversary / multitask
    forward: ``ce(logits, labels, weights)``, the emotion and gender terms
    summed for pred="multitask" (logits: the emotion head's).  ``ce`` is the
    per-row CE's normalization: :func:`weighted_ce` on one device, the local
    :func:`weighted_nll_sum` over the global real-row count under data
    parallelism."""
    out = model(spec, pooling=pooling, dropout=draws, global_feature=g)
    if model.pred == "multitask":
        out, gen_out = out
        return ce(out, labels, weights) + ce(gen_out, labels_gen, weights), out
    return ce(out, labels, weights), out


def _baseline_update(state, spec, labels, weights, labels_gen, pooling, g=None):
    with span("train.step"):
        model = state.model.train()
        with span("train.forward"):
            loss, out = baseline_loss(model, spec, labels, weights, labels_gen, pooling, g,
                                      DropoutDraws(state.generator))
        _apply(state, loss)
        return _metrics(out.detach(), labels, weights, loss)


def make_baseline_step(pooling: Optional[str] = "mean", use_global: bool = False):
    """Supervised step for baseline / adversary / multitask training:
    ``step(state, batch) -> (state, metrics)`` with ``batch`` holding
    ``spec`` (B, 1, T, D), ``labels_emo``, ``labels_gen`` and ``weight``
    (and ``global`` with ``use_global``).  pred="multitask" sums emotion and
    gender CE; metrics track the emotion head.  ``pooling`` must match
    evaluation's."""
    f32_precision()

    def step(state: TrainState, batch: dict):
        key = "labels_gen" if state.model.pred == "gender" else "labels_emo"
        g = batch["global"] if use_global else None
        return state, _baseline_update(state, batch["spec"], batch[key], batch["weight"],
                                       batch["labels_gen"], pooling, g)

    return step


def make_epoch_runner(pooling: Optional[str] = "mean", use_global: bool = False):
    """Whole-epoch trainer over device-resident windows:
    ``run(state, windows (M, T, D), labels (M,), weights (M,), order (M,),
    n_batches, batch_size[, globals_][, labels_gen]) -> (state, losses,
    correct, counts)``, one batch after another in ``order``.  ``labels``
    are the model's own targets; pass ``labels_gen`` for pred="multitask"
    and ``globals_`` (M, 88) with ``use_global``."""
    f32_precision()

    def run(runner, state, windows, labels, weights, order, *, n_batches: int,
            batch_size: int, globals_=None, labels_gen=None):
        g = globals_ if use_global else None

        def update(st, i, idx):
            return _baseline_update(st, windows[idx][:, None], labels[idx], weights[idx],
                                    None if labels_gen is None else labels_gen[idx],
                                    pooling, None if g is None else g[idx])

        return (state, *runner.steps(state, update, (windows, labels, weights, labels_gen, g),
                                     order, n_batches, batch_size, graphed=True))

    return _EpochRunner(run)


def make_eval_logits_fn(model: nn.Module, use_global: bool = False, **forward_kwargs):
    """Eval forward: ``fn(spec (B, 1, T, D), global_feature=None) ->
    model(spec, **forward_kwargs)`` in eval mode under
    ``torch.inference_mode`` with TF32 off; the (B, 88) ``global_feature``
    goes to the model with ``use_global`` and is dropped without.  Returns
    the tuple of both heads for pred="multitask", a cloaked model's tuple
    whole (its first element is the emotion logits).  The model's mode is
    put back after each call, so a validation pass between two train epochs
    leaves it training; no graph is built, so no backward kernel runs and
    nothing is saved for one."""
    f32_precision()

    def fn(spec, global_feature=None):
        was_training = model.training
        model.eval()
        g = {"global_feature": global_feature} if use_global else {}
        try:
            with torch.inference_mode():
                return model(spec, **g, **forward_kwargs)
        finally:
            model.train(was_training)

    return fn


# ---------------------------------------------------------------------------
# cloak and cloak + GRL


def cloak_loss(model, spec, labels, weights, eps, mask, pooling, antithetic, g,
               ce=weighted_ce):
    """(loss, logits) of a ``CloakedModel`` forward with the draw ``eps``;
    ``antithetic``: the mean of the +eps and -eps passes.  ``ce`` as in
    :func:`baseline_loss`; no regularizer."""
    def branch(sign):
        return model(spec, eps, mask=mask, pooling=pooling, noise_sign=sign,
                     global_feature=g)[0]

    logits = branch(1.0)
    loss = ce(logits, labels, weights)
    if antithetic:
        loss = 0.5 * (loss + ce(branch(-1.0), labels, weights))
    return loss, logits


def grl_loss(model, spec, labels_emo, labels_gen, weights, eps, mask, pooling, antithetic,
             gender_lambda, draws, g, ce=weighted_ce):
    """(loss, emotion logits, gender logits) of a ``CloakedModelGRL``
    forward: ``ce(emo) + gender_lambda * ce(gen)``; ``antithetic``: the mean
    with the -eps pass, which replays ``draws``' masks and leaves the running
    statistics alone.  ``ce`` as in :func:`baseline_loss`; no regularizer."""
    def pair_loss(emo_logits, gen_logits):
        return ce(emo_logits, labels_emo, weights) + gender_lambda * ce(
            gen_logits, labels_gen, weights)

    emo, gen, _ = model(spec, eps, mask=mask, pooling=pooling, dropout=draws,
                        global_feature=g)
    loss = pair_loss(emo, gen)
    if antithetic:
        emo_m, gen_m, _ = model(spec, eps, mask=mask, pooling=pooling, noise_sign=-1.0,
                                dropout=draws.replay(), update_stats=False, global_feature=g)
        loss = 0.5 * (loss + pair_loss(emo_m, gen_m))
    return loss, emo, gen


def make_cloak_step(scale_lambda: float = 0.0, apply_scale_reg: bool = True,
                    pooling: Optional[str] = "mean", antithetic: bool = False,
                    use_global: bool = False):
    """Cloak step on a ``CloakedModel`` whose backbone the optimizer froze:
    ``step(state, batch, mask=None, eps=None) -> (state, metrics)``;
    ``batch["global"]`` goes to the backbone with ``use_global``.

    ``antithetic``: the loss is the mean of the +eps and -eps passes of one
    draw; the first-order noise of the sigma gradient cancels between them.
    """
    f32_precision()

    def step(state: TrainState, batch: dict, mask=None, eps=None):
        with span("train.step"):
            model = state.model.train()
            key = "labels_emo" if model.backbone.pred == "emotion" else "labels_gen"
            labels, w = batch[key], batch["weight"]
            with span("train.forward"):
                if eps is None:
                    eps = model.noise.draw_eps(state.generator)
                g = batch["global"] if use_global else None
                loss, logits = cloak_loss(model, batch["spec"], labels, w, eps, mask, pooling,
                                          antithetic, g)
                loss = scale_reg(model, loss, scale_lambda, apply_scale_reg)
            _apply(state, loss)
            return state, _metrics(logits.detach(), labels, w, loss)

    return step


def make_cloak_grl_step(scale_lambda: float = 0.0, gender_lambda: float = 0.1,
                        apply_scale_reg: bool = True, pooling: Optional[str] = "mean",
                        antithetic: bool = False, saliency_align: float = 0.0,
                        use_global: bool = False):
    """Cloak + GRL minimax step on a ``CloakedModelGRL`` (noise and gender
    adversary trainable): ``step(state, batch, mask=None, eps=None)``.

    ``antithetic``: the -eps pass reuses the +eps pass's dropout masks and
    leaves the gender backbone's running statistics alone; metrics and BN
    statistics come from the +eps pass, as in the JAX package.
    ``saliency_align``: weight of :func:`saliency_alignment_loss`, whose
    saliencies are taken before the forward updates the gender backbone's
    running statistics (the JAX step reads the step's incoming statistics).
    ``batch["global"]`` goes to both backbones with ``use_global``.
    """
    f32_precision()

    def step(state: TrainState, batch: dict, mask=None, eps=None):
        with span("train.step"):
            model = state.model.train()
            le, lg, w = batch["labels_emo"], batch["labels_gen"], batch["weight"]
            with span("train.forward"):
                if eps is None:
                    eps = model.noise.draw_eps(state.generator)
                draws = DropoutDraws(state.generator)
                g = batch["global"] if use_global else None
                align = (saliency_alignment_loss(model, batch["spec"], le, lg, w, pooling, g)
                         if saliency_align else None)
                loss, emo, gen = grl_loss(model, batch["spec"], le, lg, w, eps, mask, pooling,
                                          antithetic, gender_lambda, draws, g)
                loss = scale_reg(model, loss, scale_lambda, apply_scale_reg)
                if align is not None:
                    loss = loss + saliency_align * align
            _apply(state, loss)
            m = _metrics(emo.detach(), le, w, loss)
            m["gender_correct"] = ((gen.detach().argmax(-1) == lg) * (w > 0)).sum()
            return state, m

    return step


def make_cloak_epoch_runner(scale_lambda: float = 0.0, gender_lambda: float = 0.1,
                            grl: bool = False, apply_scale_reg: bool = True,
                            pooling: Optional[str] = "mean", antithetic: bool = False,
                            saliency_align: float = 0.0, use_global: bool = False):
    """Whole-epoch cloak / cloak + GRL trainer: ``run(state, windows (M, T,
    D), labels_emo, labels_gen, weights, order, mask, n_batches, batch_size,
    eps=None, globals_=None) -> (state, losses, correct, counts)``;
    ``mask=None`` for unsuppressed training, ``eps`` (n_batches, 1, T, D) to
    inject the draws, ``globals_`` (M, 88) with ``use_global``.
    ``saliency_align`` applies to the GRL game only, as in the JAX package."""
    step = (make_cloak_grl_step(scale_lambda, gender_lambda, apply_scale_reg, pooling,
                                antithetic, saliency_align, use_global) if grl else
            make_cloak_step(scale_lambda, apply_scale_reg, pooling, antithetic, use_global))

    def run(runner, state, windows, labels_emo, labels_gen, weights, order, mask, *,
            n_batches: int, batch_size: int, eps=None, globals_=None):
        g = globals_ if use_global else None

        def update(st, i, idx):
            batch = {"spec": windows[idx][:, None], "labels_emo": labels_emo[idx],
                     "labels_gen": labels_gen[idx], "weight": weights[idx]}
            if g is not None:
                batch["global"] = g[idx]
            return step(st, batch, mask, None if eps is None else eps[i])[1]

        return (state, *runner.steps(state, update,
                                     (windows, labels_emo, labels_gen, weights, g, mask),
                                     order, n_batches, batch_size, graphed=eps is None))

    return _EpochRunner(run)
