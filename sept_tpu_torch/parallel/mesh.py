"""Process groups: the port's counterpart of a 1-D data mesh.

Counterpart of ``sept_tpu/parallel/mesh.py``.  Where the JAX package runs
one process over a ``Mesh`` of devices, the port runs one process per
device, a rank of a ``torch.distributed`` process group:

- :func:`spawn` starts one rank a device on this host with the ``spawn``
  start method; :func:`make_group` names the devices of an n-rank group
  (cuda:0 .. cuda:n-1, or the CPU n times), as ``make_mesh`` takes the first
  n devices, and raises on more than are visible.  The backend defaults to
  NCCL on CUDA and gloo on the CPU; it is never switched behind the caller's
  back (two ranks on one card need gloo, which NCCL refuses);
- :func:`init_distributed` makes this process one rank of a multi-host
  world (``init_process_group`` over ``tcp://<coordinator>``), as
  ``jax.distributed.initialize`` does;
- each rank holds a :class:`DataGroup` (its rank, the world size, its device
  and backend) and reduces through it: :meth:`DataGroup.sum_` (in place)
  and :meth:`DataGroup.sum` (differentiable: its backward sums the
  cotangents over the ranks too, as ``psum`` transposes);
- :func:`broadcast_state` is ``replicate_state`` / ``put_replicated``: rank
  0's parameters, buffers and optimizer state on every rank;
- :func:`pad_batch_to_multiple` is the JAX package's, on numpy arrays.

Every process group gets a finite ``timeout``, so a collective that a peer
never joins raises in its rank; :func:`spawn` re-raises the first rank's
error once the others are stopped, and kills every rank past a deadline
where the caller gives one, so that a rank that raises never leaves its
peers blocked.  Collectives run outside the kernels, between them.  Gloo on
CUDA tensors stages through the host and has ``all_reduce`` and
``broadcast`` but no ``all_gather``: the port's collectives are sums and
broadcasts only.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sept_tpu_torch.device import f32_precision, resolve_device

__all__ = [
    "DataGroup",
    "broadcast_state",
    "current_group",
    "init_distributed",
    "is_main",
    "barrier",
    "make_group",
    "pad_batch_to_multiple",
    "rank_generator",
    "spawn",
    "sync_gradients",
    "visible_devices",
]

TIMEOUT_S = 300.0  # every collective of a process group
_HOST = "127.0.0.1"
_current: Optional["DataGroup"] = None


@dataclasses.dataclass(eq=False)
class DataGroup:
    """This process's place in a data-parallel group: ``rank`` of
    ``world_size``, on ``device``, over ``backend``.  ``calls`` and
    ``seconds`` count the all-reduces it ran and their host wall time (gloo
    returns when the reduction is done; NCCL when it is queued)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    calls: int = 0
    seconds: float = 0.0

    def __deepcopy__(self, memo):  # a model holding its group copies by reference
        return self

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce ``t`` in place (sum over the ranks); returns it."""
        t0 = time.perf_counter()
        dist.all_reduce(t)
        self.seconds += time.perf_counter() - t0
        self.calls += 1
        return t

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, differentiable: the backward sums
        the cotangents over the ranks as well."""
        return _AllReduceSum.apply(t, self)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.sum_(torch.clone(x, memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return ctx.group.sum_(torch.clone(g, memory_format=torch.contiguous_format)), None


def current_group() -> Optional[DataGroup]:
    """The DataGroup of this process once it is a rank (:func:`spawn`,
    :func:`init_distributed`), else None."""
    return _current


def is_main(group: Optional[DataGroup]) -> bool:
    """True on the process that writes: rank 0, or a run without a group."""
    return group is None or group.rank == 0


def barrier(group: Optional[DataGroup]) -> None:
    if group is not None:
        group.barrier()


def _backend(device: torch.device, backend: Optional[str]) -> str:
    return backend or ("nccl" if device.type == "cuda" else "gloo")


def _timeout(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     device="cuda", timeout_s: float = TIMEOUT_S) -> Optional[DataGroup]:
    """Make this process rank ``process_id`` of ``num_processes``, meeting
    the others at ``coordinator`` (``host:port``), and return its
    DataGroup.  No-op (None) for a single process; the current group if this
    process is a rank already.  On CUDA the rank takes card ``process_id %
    device_count`` of its host."""
    global _current
    if not num_processes or num_processes <= 1:
        return None
    if _current is not None:
        return _current
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = _backend(dev, backend)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=_timeout(timeout_s))
    _current = DataGroup(process_id, num_processes, dev, backend)
    return _current


def visible_devices(device="cuda") -> int:
    """Devices a group can take on this host: the cards for CUDA, the cores
    for the CPU (one rank a core)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return len(os.sched_getaffinity(0))


def make_group(n_devices: Optional[int] = None, device="cuda") -> tuple[torch.device, ...]:
    """The devices of an ``n_devices``-rank group on this host (default:
    all): the first ``n_devices`` cards, or the CPU once a rank.  An
    explicit request for more than are visible raises: a smaller group
    would run the job at the wrong scale, and nothing downstream would
    notice."""
    dev = resolve_device(device)
    avail = visible_devices(dev)
    n = avail if n_devices is None else n_devices
    if n > avail:
        raise ValueError(f"requested a {n}-device group but only {avail} "
                         f"{dev.type} devices are visible")
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(n))
    return (torch.device("cpu"),) * n


def _rank_main(fn, args, rank, devices, port, backend, timeout_s, threads, out):
    """One spawned rank: join the group, run ``fn(group, *args)``, report."""
    global _current
    try:
        dev = devices[rank]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if threads:
            torch.set_num_threads(threads)
        f32_precision()
        store = dist.TCPStore(_HOST, port, len(devices), False, timeout=_timeout(timeout_s))
        dist.init_process_group(backend, store=store, rank=rank, world_size=len(devices),
                                timeout=_timeout(timeout_s))
        _current = DataGroup(rank, len(devices), dev, backend)
        report = (rank, True, fn(_current, *args))
    except BaseException as e:  # noqa: BLE001 -- reported to the parent, re-raised there
        report = (rank, False, (e, traceback.format_exc()))
    try:
        payload = pickle.dumps(report)
    except Exception:  # noqa: BLE001 -- an unpicklable result or error travels as text
        payload = pickle.dumps((rank, False, (None, report[2][1] if not report[1]
                                              else traceback.format_exc())))
    # report before leaving the group: a peer blocked in a collective fails
    # once this rank's connections close, and its error must not come first
    out.put(payload)
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn: Callable, devices: Sequence, *args, backend: Optional[str] = None,
          timeout_s: float = TIMEOUT_S, deadline_s: Optional[float] = None,
          threads: int = 0) -> list:
    """Run ``fn(group, *args)`` in ``len(devices)`` new processes, rank r on
    ``devices[r]`` (:func:`make_group`; two ranks may share a card), and
    return their return values by rank.  ``fn`` and its arguments must be
    picklable (``fn`` defined at the top of an importable module) and so
    must its return value.  ``backend`` defaults to NCCL on CUDA, gloo on
    the CPU; ``timeout_s`` bounds each collective; ``deadline_s`` bounds the
    whole run, past which every rank is killed (None: a training run takes
    as long as it takes, and a hang surfaces as a collective's timeout).
    ``threads`` > 0 sets each rank's torch threads.  A rank that raises
    makes this raise its exception (the rank's traceback in a note) once
    the others are stopped."""
    devices = tuple(torch.device(d) for d in devices)
    backend = _backend(devices[0], backend)
    ctx = torch.multiprocessing.get_context("spawn")
    # the rendezvous store lives here, so no port is picked and given up
    store = dist.TCPStore(_HOST, 0, len(devices), True, timeout=_timeout(timeout_s),
                          wait_for_workers=False)
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, args, r, devices, store.port, backend, timeout_s,
                               threads, out))
             for r in range(len(devices))]
    for p in procs:
        p.start()
    results, failure = {}, None
    stop = None if deadline_s is None else time.monotonic() + deadline_s
    try:
        while len(results) < len(procs) and failure is None:
            left = 1.0 if stop is None else stop - time.monotonic()
            if left <= 0:
                failure = (TimeoutError(f"{len(procs)} ranks still running after the "
                                        f"deadline; killed"), "")
                break
            try:
                rank, ok, value = pickle.loads(out.get(timeout=min(left, 1.0)))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    failure = (RuntimeError(f"rank {dead[0]} died with exit code "
                                            f"{procs[dead[0]].exitcode}"), "")
                continue
            if ok:
                results[rank] = value
            else:
                failure = value
    finally:
        for p in procs:
            p.join(timeout=0 if failure is not None else 10)
            if p.is_alive():
                p.kill()
                p.join()
    if failure is not None:
        exc, tb = failure
        if exc is None:
            raise RuntimeError(f"a rank failed:\n{tb}")
        if tb:
            exc.add_note(f"in the rank:\n{tb}")
        raise exc
    return [results[r] for r in range(len(procs))]


def broadcast_state(state, group: Optional[DataGroup]):
    """Rank 0's parameters, buffers and optimizer state on every rank (a
    :class:`sept_tpu_torch.train.steps.TrainState`, in place); returns the
    state.  No-op without a group."""
    if group is None:
        return state
    with torch.no_grad():
        for t in state.model.state_dict().values():
            group.broadcast_(t)
        # Adam's step counts stay on the host under NCCL; every rank counts
        # the same steps
        for per_param in state.optimizer.torch_opt.state.values():
            for v in per_param.values():
                if isinstance(v, torch.Tensor) and v.device.type == group.device.type:
                    group.broadcast_(v)
    return state


def pad_batch_to_multiple(batch: dict, multiple: int) -> dict:
    """Zero-pad the batch's leading dim to a multiple of ``multiple`` (the
    world size), the ``weight`` rows too, so padded rows contribute nothing
    to the loss."""
    n = len(batch["weight"])
    pad = (-n) % multiple
    if pad == 0:
        return batch
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = np.concatenate([v, np.zeros((pad,) + v.shape[1:], dtype=v.dtype)])
    return out


def sync_gradients(model, group: DataGroup, extras=()) -> torch.Tensor:
    """One all-reduce of one flat f32 buffer after a rank's backward: the
    parameters' gradients (summed, left in ``.grad``), the model's floating
    buffers (averaged in place: the running statistics, as JAX takes their
    ``pmean``) and ``extras`` (summed and returned, flat: the step's
    metrics).  Every rank runs the same model, so the buffers line up."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    flat = torch.cat([t.reshape(-1).float() for t in grads + bufs]
                     + [torch.as_tensor(e).detach().reshape(-1).float().to(group.device)
                        for e in extras])
    group.sum_(flat)
    off = 0
    with torch.no_grad():
        for t, scale in [(g, 1.0) for g in grads] + [(b, group.world_size) for b in bufs]:
            part = flat[off:off + t.numel()].view_as(t)
            t.copy_(part if scale == 1.0 else part / scale)
            off += t.numel()
    return flat[off:]


def rank_generator(state, group: DataGroup) -> torch.Generator:
    """This rank's dropout generator from ``state.step`` on: seeded from the
    state generator's seed, the step and the rank, as JAX folds the axis
    index into the dropout key, so the ranks draw different masks while the
    state's own stream (the cloak's shared epsilon) is left as one device
    leaves it.  A resumed state (same seed and step) gets the same masks."""
    words = np.random.SeedSequence(
        [state.generator.initial_seed(), state.step, group.rank]).generate_state(2)
    seed = (int(words[0]) << 31) ^ int(words[1])
    return torch.Generator(device=state.generator.device).manual_seed(seed)
