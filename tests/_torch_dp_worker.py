"""What the ranks of the port's data-parallel tests run (CPU, gloo).

Spawned ranks import this module by name, so it imports torch and the port
and nothing of JAX; every function takes the rank's DataGroup first, takes
numpy inputs and returns numpy results, which the test process holds
against one device and against the JAX package.
"""

import numpy as np
import torch

from sept_tpu_torch.ops import conv_block1 as K

EPS = 1e-5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def rows(group, n):
    """This rank's slice of ``n`` rows."""
    k = n // group.world_size
    return slice(group.rank * k, (group.rank + 1) * k)


def block1_leaves(d, sl=slice(None)):
    """x, weight, bias, gamma, beta as NCHW leaves needing gradients (x's
    rows ``sl``) from the JAX layout of ``d``."""
    t = torch.from_numpy
    return [t(d["x"][sl]).permute(0, 3, 1, 2).contiguous().requires_grad_(),
            t(d["k"]).permute(3, 2, 0, 1).contiguous().requires_grad_(),
            t(d["bias"]).requires_grad_(), t(d["gamma"]).requires_grad_(),
            t(d["beta"]).requires_grad_()]


def block1_train(d, dtype, group=None, sl=slice(None)):
    """Train-mode block 1 on rows ``sl`` of ``d`` and its VJP with ``d["cot"]``'s
    rows: {pooled, mean, var, dx, dW, db, dgamma, dbeta} as f32 numpy."""
    cd = DTYPES[dtype]
    leaves = block1_leaves(d, sl)
    pooled, mean, var = K.Block1Train.apply(*leaves, EPS, cd, group)
    cot = torch.from_numpy(d["cot"][sl]).permute(0, 3, 1, 2).to(cd)
    grads = torch.autograd.grad(pooled, leaves, cot)
    out = {"pooled": pooled.detach().float(), "mean": mean, "var": var}
    out.update(zip(("dx", "dW", "db", "dgamma", "dbeta"), grads))
    return {k: v.detach().numpy() for k, v in out.items()}


def block1_case(group, d):
    """The sync-BN block on this rank's rows, in both modes, and the count
    of all-reduces each mode ran."""
    sl = rows(group, len(d["x"]))
    out = {}
    for dtype in DTYPES:
        before = group.calls
        out[dtype] = block1_train(d, dtype, group, sl)
        out[dtype]["all_reduces"] = group.calls - before
    return out


# ---------------------------------------------------------------------------
# the epoch runners, the DP step, the fold drivers, the mid-fold resume and
# the sweep (tests/test_torch_parallel.py); group None: one device

H, WIN, D, B, N_BATCHES = 8, 20, 16, 8, 2
SGD = dict(optimizer="sgd", learning_rate=1e-2, weight_decay=1e-4)


def _numpy_state(model):
    return {k: v.detach().float().numpy().copy() for k, v in model.state_dict().items()
            if v.is_floating_point()}


def _backbone(pred, group=None, dtype="float32", global_dim=0, sd=None, seed=0):
    from sept_tpu_torch.models import Conv2dBiRNN

    torch.manual_seed(seed)
    m = Conv2dBiRNN(hidden_size=H, feature_len=D, pred=pred, dropout_rate=0.0,
                    compute_dtype=DTYPES[dtype], bn_group=group, global_dim=global_dim)
    if sd is not None:
        m.load_state_dict(sd)
    return m


def _epoch_out(out, model):
    _, losses, correct, counts = out
    return {"losses": losses.numpy(), "correct": correct.numpy(), "counts": counts.numpy(),
            "state": _numpy_state(model)}


def epoch_case(group, inp, case):
    """One baseline epoch (``case``: "baseline", "multitask" or "bf16") from
    ``inp[case]["sd"]`` on ``inp["data"]``."""
    from sept_tpu_torch.parallel import make_epoch_runner_dp
    from sept_tpu_torch.train.config import ExperimentConfig
    from sept_tpu_torch.train.optim import make_optimizer
    from sept_tpu_torch.train.steps import init_state, make_epoch_runner

    c, d = inp[case], inp["data"]
    model = _backbone(c["pred"], group, c["dtype"], sd=c["sd"])
    state = init_state(model, make_optimizer(ExperimentConfig(**SGD), N_BATCHES, model),
                       device="cpu")
    run = make_epoch_runner() if group is None else make_epoch_runner_dp(group)
    t = torch.from_numpy
    kw = {"labels_gen": t(d["lg"]).long()} if c["pred"] == "multitask" else {}
    out = run(state, t(d["windows"]), t(d["le"]).long(), t(d["w"]), d["order"],
              n_batches=N_BATCHES, batch_size=B, **kw)
    return _epoch_out(out, model)


def _grl_model(group, c):
    from sept_tpu_torch.models import CloakedModelGRL, N_GLOBAL

    g = N_GLOBAL if c["use_global"] else 0
    model = CloakedModelGRL(_backbone("emotion", global_dim=g),
                            _backbone("gender", group, global_dim=g), grl_lambda=0.5,
                            win_len=WIN, n_feats=D)
    model.load_state_dict(c["sd"])
    return model


def grl_case(group, inp, case):
    """One cloak + GRL epoch (``case``: "grl", "grl_global" or "saliency")
    with JAX's epsilon draws injected."""
    from sept_tpu_torch.parallel import make_cloak_epoch_runner_dp
    from sept_tpu_torch.train.config import ExperimentConfig
    from sept_tpu_torch.train.optim import make_cloak_optimizer
    from sept_tpu_torch.train.steps import init_state, make_cloak_epoch_runner

    c, d = inp[case], inp["data"]
    model = _grl_model(group, c)
    opt = make_cloak_optimizer(ExperimentConfig(**SGD), 10, model, ("noise", "gender_backbone"))
    state = init_state(model, opt, device="cpu")
    opts = dict(scale_lambda=0.1, gender_lambda=0.3, grl=True,
                saliency_align=c["saliency_align"], use_global=c["use_global"])
    run = (make_cloak_epoch_runner(**opts) if group is None
           else make_cloak_epoch_runner_dp(group, **opts))
    t = torch.from_numpy
    out = run(state, t(d["windows"]), t(d["le"]).long(), t(d["lg"]).long(), t(c["w"]),
              d["order"], None, n_batches=N_BATCHES, batch_size=B, eps=t(c["eps"]),
              globals_=t(d["globals"]) if c["use_global"] else None)
    return _epoch_out(out, model)


def dp_step_case(group, inp):
    """Two baseline steps on the whole batch: make_dp_step with a group,
    make_baseline_step without."""
    from sept_tpu_torch.parallel import make_dp_step
    from sept_tpu_torch.train.config import ExperimentConfig
    from sept_tpu_torch.train.optim import make_optimizer
    from sept_tpu_torch.train.steps import init_state, make_baseline_step

    c = inp["baseline"]
    model = _backbone("emotion", group, sd=c["sd"])
    state = init_state(model, make_optimizer(ExperimentConfig(**SGD), 10, model), device="cpu")
    step = make_baseline_step() if group is None else make_dp_step(group)
    metrics = []
    for batch in inp["steps"]:
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        metrics.append({k: v.numpy() for k, v in m.items()})
    return {"metrics": metrics, "state": _numpy_state(model)}


def _fit_cfg(grl, epochs):
    from sept_tpu_torch.train.config import ExperimentConfig

    return ExperimentConfig(win_len=WIN, feature_len=D, batch_size=B, num_epochs=epochs,
                            hidden_size=H, optimizer="sgd", learning_rate=1e-2,
                            weight_decay=0.0, min_select_epoch=0, grl=grl, scale_lambda=0.1,
                            gender_lambda=0.3)


def _result(res):
    return {"train_loss": [h["train"]["loss"] for h in res.history],
            "val_loss": [h["validate"]["loss"] for h in res.history],
            "val_acc": [h["validate"]["acc"] for h in res.history],
            "test_acc": [h["test"]["acc"] for h in res.history],
            "best_epoch": res.best_epoch, "final_test_acc": res.final_test_acc,
            "best": {k: v.float().numpy() for k, v in res.best_state["model"].items()
                     if v.is_floating_point()}}


def fit_case(group, inp, grl=False, epochs=2, resume_path=None):
    """fit_device (the baseline) or fit_device_cloak (the GRL game, epsilon
    from the state's generator) on ``inp["fold"]``."""
    from sept_tpu_torch.data.pipeline import SplitArrays
    from sept_tpu_torch.models import CloakedModelGRL
    from sept_tpu_torch.train.device_loop import fit_device, fit_device_cloak
    from sept_tpu_torch.train.optim import make_cloak_optimizer, make_optimizer
    from sept_tpu_torch.train.steps import init_state, make_eval_logits_fn

    cfg = _fit_cfg(grl, epochs)
    tr, va, te = (SplitArrays(**inp["fold"][k]) for k in ("train", "val", "test"))
    kw = dict(verbose=False, resume_path=resume_path, group=group)
    if not grl:
        model = _backbone("emotion", group)
        state = init_state(model, make_optimizer(cfg, N_BATCHES, model), cfg.seed, "cpu")
        return _result(fit_device(state, tr, va, te, cfg, make_eval_logits_fn(model), **kw))
    model = CloakedModelGRL(_backbone("emotion", seed=1), _backbone("gender", group, seed=2),
                            grl_lambda=0.5, win_len=WIN, n_feats=D)
    opt = make_cloak_optimizer(cfg, N_BATCHES, model, ("noise", "gender_backbone"))
    state = init_state(model, opt, cfg.seed, "cpu")
    eps0 = model.noise.draw_eps(torch.Generator().manual_seed(0))
    return _result(fit_device_cloak(state, tr, va, te, cfg,
                                    make_eval_logits_fn(model, eps=eps0), **kw))


def midfold_case(group, inp, path):
    """A 4-epoch fold, and the same fold cut after 2 epochs with its
    mid-fold checkpoint kept, then resumed to 4."""
    from sept_tpu_torch.parallel import barrier
    from sept_tpu_torch.train.midfold import MidFoldCheckpoint

    ref = fit_case(group, inp, epochs=4)
    delete = MidFoldCheckpoint.delete
    MidFoldCheckpoint.delete = lambda self: barrier(self.group)
    try:
        fit_case(group, inp, epochs=2, resume_path=path)
    finally:
        MidFoldCheckpoint.delete = delete
    existed = MidFoldCheckpoint(path).exists()
    res = fit_case(group, inp, epochs=4, resume_path=path)
    return {"ref": ref, "resumed": res, "existed": existed}


def sweep_case(group, inp, batch_size):
    """evaluate_cloaked_test of a seeded SweepModel on ``inp["fold"]["test"]``."""
    from sept_tpu_torch.data.pipeline import SplitArrays
    from sept_tpu_torch.eval.sweep import SweepModel, evaluate_cloaked_test

    model = SweepModel(_backbone("emotion", seed=3), _backbone("gender", seed=4),
                       win_len=WIN, n_feats=D)
    with torch.no_grad():
        model.noise.rhos.copy_(torch.linspace(-2, 2, WIN * D).reshape(1, WIN, D))
    b, a = evaluate_cloaked_test(model, SplitArrays(**inp["fold"]["test"]), inp["mask"],
                                 win_len=WIN, shift_len=5, batch_size=batch_size, group=group)
    return {"baseline": b, "adversary": a}


def all_cases(group, inp, path):
    """Every case of tests/test_torch_parallel.py on this rank, and the
    all-reduces each ran."""
    out = {}
    cases = [(c, epoch_case, (c,)) for c in ("baseline", "multitask", "bf16")]
    cases += [(c, grl_case, (c,)) for c in ("grl", "grl_global", "saliency")]
    cases += [("dp_step", dp_step_case, ()), ("fit", fit_case, ()),
              ("fit_cloak", fit_case, (True,)), ("midfold", midfold_case, (path,)),
              ("sweep8", sweep_case, (8,)), ("sweep5", sweep_case, (5,))]
    for name, fn, args in cases:
        before = group.calls
        out[name] = fn(group, inp, *args)
        out[name + "_all_reduces"] = group.calls - before
    return out


def fail_on_rank_1(group):
    """Rank 1 raises while rank 0 waits for it in an all-reduce."""
    if group.rank == 1:
        raise ValueError("rank 1 failed")
    group.sum_(torch.ones(1))


def sleep(group, seconds):
    import time

    time.sleep(seconds)
