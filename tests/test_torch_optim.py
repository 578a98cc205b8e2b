"""The port's optimizers, schedule and freezing vs sept_tpu.train.optim (CPU).

Tolerances: the schedule 1e-7 relative (JAX evaluates it in f32); SGD and
Adam parameters 1e-6 * max(|p|, 1) after 5 updates of one tree.
"""

import dataclasses
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from sept_tpu.train import config as jconfig
from sept_tpu.train import optim as joptim
from sept_tpu_torch.models import CloakedModel, Conv2dBiRNN
from sept_tpu_torch.train import config, optim


@pytest.mark.parametrize("name", ["baseline", "adversary", "cloak", "cloak_grl"])
def test_preset_matches_jax(name):
    ours = dataclasses.asdict(config.preset(name))
    theirs = dataclasses.asdict(jconfig.preset(name))
    assert ours == {k: theirs[k] for k in ours}


def test_every_config_field_is_read():
    """No option of the port's config is dead: each field is read as an
    attribute by the package or by the script that drives it."""
    root = pathlib.Path(__file__).resolve().parents[1]
    text = "\n".join(p.read_text() for p in [*(root / "sept_tpu_torch").rglob("*.py"),
                                            root / "chip_smoke.py"])
    unread = [f.name for f in dataclasses.fields(config.ExperimentConfig)
              if not re.search(rf"\.{f.name}\b", text)]
    assert not unread


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_schedule_matches_jax(k, opt):
    kw = dict(optimizer=opt, learning_rate=1e-3, lr_step_epochs=2, lr_gamma=0.5,
              lr_sched_steps_per_epoch=k)
    spe = 4
    ours = optim.make_schedule(config.ExperimentConfig(**kw), spe)
    theirs = joptim.make_schedule(jconfig.ExperimentConfig(**kw), spe)
    for count in range(3 * spe):  # three epochs
        want = float(theirs(jnp.asarray(count)) if callable(theirs) else theirs)
        assert ours(count) == pytest.approx(want, rel=1e-7)


class _Tree(nn.Module):
    def __init__(self, a, b):
        super().__init__()
        self.a = nn.Parameter(torch.from_numpy(a.copy()))
        self.b = nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_updates_match_optax(opt):
    """L2 ahead of the momentum (SGD) and of the moments (Adam, b2 0.98, eps
    1e-9), the StepLR staircase, and a plateau scale from step 3 on."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    grads = [(rng.standard_normal((4, 3)).astype(np.float32),
              rng.standard_normal(5).astype(np.float32)) for _ in range(5)]
    kw = dict(optimizer=opt, learning_rate=1e-2, weight_decay=1e-2, lr_step_epochs=1,
              lr_sched_steps_per_epoch=1)
    tx = joptim.make_optimizer(jconfig.ExperimentConfig(**kw), steps_per_epoch=2)
    params = {"a": jnp.asarray(a), "b": jnp.asarray(b)}
    state = tx.init(params)
    tree = _Tree(a, b)
    ours = optim.make_optimizer(config.ExperimentConfig(**kw), 2, tree)
    for i, (ga, gb) in enumerate(grads):
        if i == 3:
            state = joptim.set_lr_scale(state, 0.2)
            optim.set_lr_scale(ours, 0.2)
        updates, state = tx.update({"a": jnp.asarray(ga), "b": jnp.asarray(gb)}, state, params)
        params = optax.apply_updates(params, updates)
        tree.a.grad, tree.b.grad = torch.from_numpy(ga), torch.from_numpy(gb)
        ours.step()
    for name in ("a", "b"):
        want = np.asarray(params[name])
        np.testing.assert_allclose(getattr(tree, name).detach().numpy(), want,
                                   atol=1e-6 * max(np.abs(want).max(), 1.0))


def test_plateau_scheduler_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.9, 0.91, 0.92, 0.8999, 0.93, 0.94, 0.5, 0.6, 0.7, 0.8]
    ours = optim.PlateauScheduler(patience=2, factor=0.5)
    theirs = joptim.PlateauScheduler(patience=2, factor=0.5)
    scales = [ours.step(v) for v in losses]
    assert scales == [theirs.step(v) for v in losses]
    assert scales[-1] < 1.0


@pytest.mark.parametrize("freeze_rhos", [False, True])
def test_cloak_optimizer_freezes_all_but_the_noise(freeze_rhos):
    model = CloakedModel(Conv2dBiRNN(hidden_size=8, feature_len=16), win_len=40, n_feats=16)
    opt = optim.make_cloak_optimizer(config.ExperimentConfig(optimizer="sgd"), 10, model,
                                     ("noise",), freeze_rhos=freeze_rhos)
    want = ["noise.locs"] if freeze_rhos else ["noise.locs", "noise.rhos"]
    assert sorted(n for n, p in model.named_parameters() if p.requires_grad) == want
    names = {id(p): n for n, p in model.named_parameters()}
    assert sorted(names[id(p)] for g in opt.torch_opt.param_groups
                  for p in g["params"]) == want
    labels = optim.partition_labels(model, ("noise",), freeze_rhos)
    jlabels = joptim.partition_labels(
        {"noise": {"locs": 0, "rhos": 0}, "backbone": {"conv0": {"kernel": 0}}},
        ("noise",), freeze_rhos)
    assert labels["noise.rhos"] == jlabels["noise"]["rhos"]
    assert labels["noise.locs"] == jlabels["noise"]["locs"] == "trainable"
    assert labels["backbone.conv.0.weight"] == jlabels["backbone"]["conv0"]["kernel"]
