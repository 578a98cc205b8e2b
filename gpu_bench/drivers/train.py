"""The training driver (traffic kind ``train``): one fold's epoch loop, as
``fit_device`` / ``fit_device_cloak`` run it, timed over whole epochs.

Set-up: seeded int16 utterances of one length go through the program's
``device_ingest`` (training and validation windows on the device); the
benchmark's seeded weights load into the program's model; the state (model,
optimizer, generator) is built once and driven through its first
``check_steps`` steps by the window's own epoch runner on distinct rows
(the numbers the reference checks are read then); the validation pass runs
once to warm its shapes.

Window: epochs of the training split in a fresh permutation each, through
the library's whole-epoch runner, each followed by the validation pass,
with the per-epoch metrics read back to the host as the fold drivers read
them.  The window closes at the end of the first epoch that ends after
``--seconds``: every run does whole epochs, so the rate is steady.
``--trace 1`` runs the same window untraced, then profiles
``trace_steps`` steps of one more epoch: the profiler's start, stop and
reduction, and whatever it leaves behind, stay out of the window's rate.
Then, in a second session, it profiles the traffic's ``span_steps`` (0
without the key) steps of the library's eager step, the one ``fit``'s host
loop runs, whose spans the epoch runners' replayed step does not open:
``Record.spans``.  Neither profile counts in the rate or in ``attempted``.

Everything that belongs to one model family (its leaves and their initial
values, the program's backbone and ingest arguments, the reference's
windows, losses and optimizer step, its FLOPs, its launch counters) comes
from the configuration's family module (``harness/cell.py::family``).

After the window the plain reference repeats the checked steps from the
same weights, windows worked out again from the same waves, and the same
dropout and noise draws (the state's generator seed), and the numbers are
compared: each step's loss, the first gradient as the optimizer holds it
(SGD's momentum buffer after one step), and each parameter's change after
the checked steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import statistics
import time

import numpy as np
import torch

from gpu_bench.harness.cell import Cell, Record, family
from gpu_bench.harness.spans import reduce_spans
from gpu_bench.harness.trace import MARKER, summarize
from gpu_bench.harness.weights import make_weights

MEDIAN_FLOOR_RULE = 1e-3  # a leaf whose reference gradient is under this share
#                           of the median leaf's moves by round-off alone


def sub_seeds(seed: int, n: int) -> list:
    """``n`` independent seeds below 2**63 from the run's seed."""
    state = np.random.SeedSequence(int(seed)).generate_state(n, dtype=np.uint64)
    return [int(s) & ((1 << 63) - 1) for s in state]


def make_waves(tr: dict, cfg: dict, seed: int, device):
    """(int16 waves (N, L) on the host, speaker ids, emotion labels, gender
    labels): two tones over a noise floor, drawn on the device."""
    dev = torch.device(device)
    n = (tr["train_windows"] + tr["val_windows"]) // tr["windows_per_utterance"]
    length = int(round(tr["utterance_s"] * cfg["sample_rate"]))
    g = torch.Generator(device=dev).manual_seed(seed)
    f = torch.rand((n, 2), generator=g, device=dev) * torch.tensor(
        [300.0, 2200.0], device=dev) + torch.tensor([100.0, 800.0], device=dev)
    t = torch.arange(length, device=dev, dtype=torch.float32) / cfg["sample_rate"]
    w = (0.3 * torch.sin(2 * np.pi * f[:, :1] * t) + 0.1 * torch.sin(2 * np.pi * f[:, 1:] * t)
         + 0.05 * torch.randn((n, length), generator=g, device=dev))
    waves = (w * 20000.0).round().clamp(-32768, 32767).to(torch.int16).cpu().numpy()
    spk = np.arange(n) % tr["speakers"]
    emo = torch.randint(0, cfg["classes"]["emotion"], (n,), generator=g, device=dev).cpu().numpy()
    return waves, spk, emo, spk % 2


@dataclasses.dataclass
class Job:
    """What the window drives: the state and its calls."""
    state: object
    model: object
    epoch: object  # epoch(state, order, n_batches) -> (state, losses, correct, counts)
    step: object  # step(state, batch) -> (state, metrics): the library's eager step
    batch: object  # batch(rows) -> the eager step's batch of training rows
    val: object  # val() -> (loss, preds)
    trainable: dict  # name -> parameter the optimizer updates
    weights: object  # the training split's row weights the steps read


def build_job(cfg: dict, tr: dict, weights: dict, gen_seed: int, eval_seed: int, ds, n_train,
              device) -> Job:
    from sept_tpu_torch.models import CloakedModelGRL, build_backbone, compute_dtype
    from sept_tpu_torch.train.config import preset
    from sept_tpu_torch.train.device_loop import make_val_pass
    from sept_tpu_torch.train.optim import make_cloak_optimizer, make_optimizer
    from sept_tpu_torch.train.steps import (init_state, make_baseline_step,
                                            make_cloak_epoch_runner, make_cloak_grl_step,
                                            make_epoch_runner, make_eval_logits_fn)

    opt = cfg["optimizer"]
    exp = preset(opt["preset"], learning_rate=opt["learning_rate"], momentum=opt["momentum"],
                 weight_decay=opt["weight_decay"], batch_size=tr["batch_size"])
    cd = compute_dtype(tr["compute_dtype"])
    bs = tr["batch_size"]
    spe = n_train // bs

    fam = family(cfg)

    def backbone(pred):
        return build_backbone(pred=pred, compute_dtype=cd, **fam.backbone_kwargs(cfg))

    tw, vw = ds.windows[:n_train], ds.windows[n_train:]
    t_emo, v_emo = ds.labels_emo[:n_train], ds.labels_emo[n_train:]
    t_gen = ds.labels_gen[:n_train]
    t_w, v_w = ds.weight[:n_train], ds.weight[n_train:]
    n_val = len(vw) // bs
    if cfg["task"] == "baseline":
        model = backbone(cfg["pred"])
        model.load_state_dict(weights)
        state = init_state(model, make_optimizer(exp, spe, model), gen_seed, device)
        runner = make_epoch_runner(pooling=cfg["pooling"])

        def epoch(st, order, n_batches):
            return runner(st, tw, t_emo, t_w, order, n_batches=n_batches, batch_size=bs)

        step = make_baseline_step(pooling=cfg["pooling"])
        logits_fn = make_eval_logits_fn(model, pooling=cfg["pooling"])
    else:
        _, win, feats = fam.noise_shape(cfg)
        model = CloakedModelGRL(backbone("emotion"), backbone("gender"),
                                grl_lambda=cfg["grl_lambda"], win_len=win, n_feats=feats,
                                min_scale=cfg["noise_min_scale"],
                                max_scale=cfg["noise_max_scale"])
        model.load_state_dict(weights)
        optimizer = make_cloak_optimizer(exp, spe, model, tuple(cfg["trainable"]))
        state = init_state(model, optimizer, gen_seed, device)
        runner = make_cloak_epoch_runner(cfg["scale_lambda"], cfg["gender_lambda"], grl=True,
                                         pooling=cfg["pooling"])

        def epoch(st, order, n_batches):
            return runner(st, tw, t_emo, t_gen, t_w, order, None, n_batches=n_batches,
                          batch_size=bs)

        step = make_cloak_grl_step(cfg["scale_lambda"], cfg["gender_lambda"],
                                   pooling=cfg["pooling"])

        eps0 = model.noise.draw_eps(torch.Generator(device=device).manual_seed(eval_seed))
        logits_fn = make_eval_logits_fn(model, eps=eps0, pooling=cfg["pooling"])
    val_pass = make_val_pass(logits_fn)

    def val():
        return val_pass(vw, v_emo, v_w, n_batches=n_val, batch_size=bs)

    def batch(rows):
        idx = torch.as_tensor(rows, dtype=torch.long, device=tw.device)
        return {"spec": tw[idx][:, None], "labels_emo": t_emo[idx], "labels_gen": t_gen[idx],
                "weight": t_w[idx]}

    trainable = {n: p for n, p in model.named_parameters() if p.requires_grad}
    return Job(state, model, epoch, step, batch, val, trainable, t_w)


def _momentum(job: Job) -> dict:
    """SGD's momentum buffers by leaf; a leaf the optimizer holds nothing for
    reads 0."""
    opt_state = job.state.optimizer.torch_opt.state
    out = {}
    for n, p in job.trainable.items():
        buf = opt_state.get(p, {}).get("momentum_buffer")
        out[n] = torch.zeros_like(p, dtype=torch.float64) if buf is None else buf.double()
    return out


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def reference_steps(cfg: dict, w0: dict, batches: list, gen_seed: int, device, prec) -> dict:
    """The plain reference over the checked steps in the family's precision
    ``prec``: losses, the first gradient's and first momentum buffer's norms
    per trainable leaf, and each leaf's change, from the benchmark's weights
    ``w0``."""
    fam = family(cfg)
    fam.f32_off()
    kinds = {k: kind for k, (_, kind) in fam.leaves(cfg).items()}
    params = [k for k in w0 if w0[k].is_floating_point() and kinds[k] not in fam.STATE_KINDS]
    trainable = {k for k in params if cfg["task"] == "baseline"
                 or k.split(".")[0] in cfg["trainable"]}
    p = {k: v.clone().requires_grad_(k in trainable) if v.is_floating_point() else v
         for k, v in w0.items()}
    g = torch.Generator(device=torch.device(device)).manual_seed(gen_seed)
    draws = fam.Draws(g)
    bufs, losses, first_grad = {}, [], None
    names = sorted(trainable)
    for x, le, lg, wts in batches:
        if cfg["task"] == "baseline":
            loss = fam.baseline_loss(p, x, le, wts, cfg, draws, prec)
        else:
            eps = cfg["eps_std"] * draws.normal(fam.noise_shape(cfg))
            loss = fam.grl_loss(p, x, le, lg, wts, cfg, eps, draws, prec)
        grads = dict(zip(names, torch.autograd.grad(loss, [p[k] for k in names])))
        if first_grad is None:
            first_grad = {k: v.clone() for k, v in grads.items()}
            for k, rows in ((k, fam.pinned_rows(k, cfg)) for k in names):
                if rows is not None:
                    first_grad[k][rows] = 0.0
        fam.sgd_step(p, grads, bufs, cfg["optimizer"], cfg)
        losses.append(float(loss.detach()))
        if len(losses) == 1:
            buf1 = _norms(bufs)
    change = _norms({k: p[k].detach() - w0[k] for k in params})
    return {"losses": losses, "grad": _norms(first_grad), "buf1": buf1, "change": change,
            "trainable": sorted(trainable)}


def compare(prog: dict, ref: dict, worst_of: dict = None) -> dict:
    """The three numbers that decide ``correct``: the worst step's relative
    loss gap, and by the worst leaf the gap between the program's and the
    reference's norms of the first momentum buffer and of the change, over
    the larger of the leaf's reference norm and the median leaf's.  Leaves
    whose reference gradient is under ``MEDIAN_FLOOR_RULE`` of the median
    leaf's are left out of the change; leaves the reference does not train
    are held to its change of 0.  ``worst_of`` gets each number's worst
    leaf."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))

    def worst(name, a: dict, b: dict, keys, med) -> float:
        gaps = {k: abs(a[k] - b[k]) / max(b[k], med, 1e-30) for k in keys}
        k = max(gaps, key=gaps.get)
        if worst_of is not None:
            worst_of[name] = k
        return gaps[k]

    keys = ref["trainable"]
    grad_gap = worst("grad_gap", prog["buf1"], ref["buf1"], keys,
                     statistics.median(ref["buf1"][k] for k in keys))
    gmed = statistics.median(ref["grad"][k] for k in keys)
    moving = [k for k in keys if ref["grad"][k] >= MEDIAN_FLOOR_RULE * gmed]
    frozen = [k for k in ref["change"] if k not in keys]
    change_gap = worst("change_gap", prog["change"], ref["change"], moving + frozen,
                       statistics.median(ref["change"][k] for k in moving))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}


class Setup:
    """Set-up of a training cell, shared by the run and the calibration."""

    def __init__(self, cell: Cell, seed: int, device, tamper=None):
        from sept_tpu_torch.data.device_pipeline import device_ingest

        cfg, tr = cell.config, cell.traffic
        self.cfg, self.tr, self.device = cfg, tr, torch.device(device)
        data_seed, weight_seed, self.gen_seed, eval_seed, perm_seed = sub_seeds(seed, 5)
        self.rng = np.random.default_rng(perm_seed)
        self.stages = {"start": time.perf_counter()}
        self.waves, self.spk, emo, gen = make_waves(tr, cfg, data_seed, device)
        self.stages["waves"] = time.perf_counter()
        self.family = family(cfg)
        ds = device_ingest(list(self.waves), self.spk, emo, gen, frontend=tr["frontend"],
                           device=device, **self.family.ingest_kwargs(cfg))
        self.stages["ingest"] = time.perf_counter()
        self.n_train = tr["train_windows"]
        if len(ds) != self.n_train + tr["val_windows"] or not bool((ds.weight > 0).all()):
            raise RuntimeError(f"ingest gave {len(ds)} windows, some padding; expected "
                               f"{self.n_train + tr['val_windows']} whole ones")
        self.w0 = make_weights(cfg, self.family, weight_seed, device)
        self.job = build_job(cfg, tr, self.w0, self.gen_seed, eval_seed, ds, self.n_train,
                             device)
        self.ds = ds
        self.stages["model"] = time.perf_counter()
        if tamper is not None:
            tamper(self.job)
        self.labels = (emo, gen)

    def first_steps(self) -> dict:
        """Drive the state through its checked steps on distinct rows of the
        training split; returns the program's readings."""
        job, bs, k = self.job, self.tr["batch_size"], self.tr["check_steps"]
        self.check_rows = self.rng.permutation(self.n_train)[:k * bs]
        losses, buf1 = [], None
        for i in range(k):
            _, loss, _, _ = job.epoch(job.state, self.check_rows[i * bs:(i + 1) * bs], 1)
            losses.append(float(loss[0]))
            if i == 0:
                buf1 = _norms(_momentum(job))
        change = _norms({n: p.detach() - self.w0[n]
                         for n, p in job.model.named_parameters()})
        return {"losses": losses, "buf1": buf1, "change": change}

    def reference(self, control: bool = False) -> dict:
        """The reference's readings over the checked steps, windows worked
        out again from the waves; ``control``: computed in the precision
        below the cell's (the family's ``PRECISIONS``)."""
        fam = self.family
        prec = fam.PRECISIONS[self.tr["compute_dtype"]][int(control)]
        dev, cfg, bs = self.device, self.cfg, self.tr["batch_size"]
        fam.f32_off()
        waves = torch.as_tensor(self.waves, device=dev)
        spk = torch.as_tensor(self.spk, device=dev)
        wins = fam.windows(waves, spk, self.check_rows, cfg).to(torch.float32)
        n_win = self.tr["windows_per_utterance"]
        utt = torch.as_tensor(self.check_rows // n_win, device=dev)
        emo = torch.as_tensor(self.labels[0], device=dev)[utt]
        gen = torch.as_tensor(self.labels[1], device=dev)[utt]
        ones = torch.ones(bs, device=dev)
        batches = [(wins[i * bs:(i + 1) * bs, None], emo[i * bs:(i + 1) * bs],
                    gen[i * bs:(i + 1) * bs], ones)
                   for i in range(self.tr["check_steps"])]
        return reference_steps(cfg, self.w0, batches, self.gen_seed, dev, prec)


def _launch_counters(cfg: dict) -> dict:
    """The family's launch counters: ``{key: (function, attribute)}``."""
    return {key: (getattr(importlib.import_module(mod), fn), attr)
            for key, (mod, fn, attr) in family(cfg).counters().items()}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        tamper=None) -> Record:
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    setup = Setup(cell, seed, device, tamper)
    prog = setup.first_steps()
    setup.stages["checked_steps"] = time.perf_counter()
    job, tr = setup.job, setup.tr
    bs = tr["batch_size"]
    n_batches = setup.n_train // bs
    loss, preds = job.val()
    float(loss), preds.cpu()
    sync()
    rec = Record()
    t0 = time.perf_counter()
    rec.setup_s = t0 - t_start
    setup.stages["val_warm"] = t0
    marks = list(setup.stages.items())
    rec.extra["setup_stages_s"] = {"process": marks[0][1] - t_start, **{
        k: marks[i][1] - marks[i - 1][1] for i, (k, _) in enumerate(marks) if i}}
    steps, bad = 0, 0
    epoch_s, e0 = [], t0
    while True:
        order = setup.rng.permutation(setup.n_train)
        _, losses, correct, cnt = job.epoch(job.state, order, n_batches)
        # the per-epoch metrics, read back as the fold drivers read them
        float(losses.mean()), float(correct.sum() / torch.clamp(cnt.sum(), min=1e-8))
        bad += int((~torch.isfinite(losses)).sum())
        loss, preds = job.val()
        float(loss), preds.cpu()
        steps += n_batches
        now = time.perf_counter()
        epoch_s.append(now - e0)
        e0 = now
        if now - t0 >= seconds:
            break
    sync()
    rec.window_s = time.perf_counter() - t0
    rec.extra["epoch_s"] = epoch_s
    rec.windows_done = steps * bs
    if cuda:
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    if trace:
        rec.slice_steps = min(tr["trace_steps"], n_batches)
        order = setup.rng.permutation(setup.n_train)
        with _profiled(rec, cuda, _launch_counters(setup.cfg)):
            losses = job.epoch(job.state, order[:rec.slice_steps * bs], rec.slice_steps)[1]
            sync()
        bad += int((~torch.isfinite(losses)).sum())
        steps += rec.slice_steps
        rec.spans = _span_steps(job, setup.rng.permutation(setup.n_train), tr, cuda, sync)
        if rec.spans is not None and rec.spans.steps:
            rec.extra["span_steps_ms"] = rec.spans.per_step_ms()
    rec.attempted, rec.failed = steps, bad
    del job, setup.job, setup.ds
    if cuda:
        torch.cuda.empty_cache()
    worst = {}
    got = compare(prog, setup.reference(), worst)
    rec.extra["worst_leaf"] = worst
    rec.checks = {k: (v, cell.limits[k]) for k, v in got.items()}
    rec.correct = bad == 0 and all(v <= lim for v, lim in rec.checks.values())
    return rec


@contextlib.contextmanager
def _session(cuda: bool):
    """A profiler session around the block, the block inside the marker."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(MARKER):
            yield prof


@contextlib.contextmanager
def _profiled(rec: Record, cuda: bool, counters: dict):
    """Profile the block inside it: the trace summary and the family's
    launch counters, zeroed at its start."""
    for f, attr in counters.values():
        setattr(f, attr, 0)
    with _session(cuda) as prof:
        yield
    rec.launches = {k: getattr(f, attr) for k, (f, attr) in counters.items()}
    rec.trace = summarize(prof)


def _span_steps(job: Job, order, tr: dict, cuda: bool, sync):
    """``span_steps`` eager steps of the library's step on rows of ``order``,
    their batches gathered before the session and one warm step before it:
    the spans of the profiled steps, or None without the key."""
    n, bs = tr.get("span_steps", 0), tr["batch_size"]
    if not n:
        return None
    batches = [job.batch(order[i * bs:(i + 1) * bs]) for i in range(n + 1)]
    job.step(job.state, batches[0])
    sync()
    with _session(cuda) as prof:
        for b in batches[1:]:
            job.step(job.state, b)
        sync()
    return reduce_spans(prof)
