"""Optimizers, the learning-rate schedule, and parameter freezing.

Counterpart of ``sept_tpu/train/optim.py``:

- SGD: ``torch.optim.SGD(momentum, weight_decay)`` adds the L2 term to the
  gradient before the momentum, as ``optax.add_decayed_weights`` + ``sgd``;
- Adam: ``torch.optim.Adam(betas=(0.9, 0.98), eps=1e-9, weight_decay)``,
  L2 in the gradient (not AdamW), as ``add_decayed_weights`` + ``adam``;
- the StepLR staircase of :func:`make_schedule` is evaluated from the update
  count before every step, as optax evaluates a schedule, and the plateau
  scale (:func:`set_lr_scale`) multiplies it, as the injected ``lr_scale``;
- freezing (the cloak) is ``requires_grad_(False)`` on the frozen parameters
  and an optimizer over the trainable ones only.  Frozen parameters then get
  no update and no decay, as optax's ``set_to_zero`` partition gives them,
  and the backward skips their gradients (no K4 for a frozen block 1).
"""

from __future__ import annotations

import copy
from typing import Callable, Iterable, Optional

import torch
from torch import nn

from sept_tpu_torch.train.config import ExperimentConfig
from sept_tpu_torch.utils.profiling import span

__all__ = [
    "Optimizer",
    "make_schedule",
    "make_optimizer",
    "make_cloak_optimizer",
    "partition_labels",
    "PlateauScheduler",
    "set_lr_scale",
]


def make_schedule(cfg: ExperimentConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """Learning rate of the update with (0-based) count ``count``.

    SGD: StepLR at epoch granularity with the reference quirk that the
    baseline and plain-cloak trainers call ``scheduler.step()`` after both
    the train and the validate pass (``lr_sched_steps_per_epoch`` k = 2), so
    ``lr(epoch) = lr0 * gamma ** ((k * epoch) // s)``, constant within an
    epoch.  Adam: the constant base rate (the plateau scales it).
    """
    if cfg.optimizer == "sgd":
        spe = max(1, steps_per_epoch)
        k = cfg.lr_sched_steps_per_epoch
        s = max(1, cfg.lr_step_epochs)
        return lambda count: cfg.learning_rate * cfg.lr_gamma ** ((k * (count // spe)) // s)
    return lambda count: cfg.learning_rate


class Optimizer:
    """A torch optimizer driven by a schedule of the update count and a
    plateau scale: ``lr = schedule(count) * lr_scale`` before each step."""

    def __init__(self, torch_opt: torch.optim.Optimizer,
                 schedule: Callable[[int], float]):
        self.torch_opt = torch_opt
        self.schedule = schedule
        self.lr_scale = 1.0
        self.count = 0

    def zero_grad(self):
        self.torch_opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """A copy of the torch optimizer's state, the plateau scale and the
        update count (the schedule is a function of the count)."""
        return {"torch": copy.deepcopy(self.torch_opt.state_dict()),
                "lr_scale": self.lr_scale, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        # a copy: torch's load keeps the given tensors where it can, and the
        # steps after would write into them
        self.torch_opt.load_state_dict(copy.deepcopy(state["torch"]))
        self.lr_scale = float(state["lr_scale"])
        self.count = int(state["count"])

    def lr(self) -> float:
        """The learning rate of the next update: ``schedule(count) * lr_scale``."""
        return self.schedule(self.count) * self.lr_scale

    def step(self):
        """One update at :meth:`lr`, a ``train.optimizer`` span in a profiler
        session."""
        with span("train.optimizer"):
            lr = self.lr()
            for group in self.torch_opt.param_groups:
                group["lr"] = lr
            self.torch_opt.step()
            self.count += 1


def _torch_opt(cfg: ExperimentConfig, params) -> torch.optim.Optimizer:
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.learning_rate, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.98),
                                eps=1e-9, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer: {cfg.optimizer!r}")


def make_optimizer(cfg: ExperimentConfig, steps_per_epoch: int,
                   model: nn.Module) -> Optimizer:
    """Full-model optimizer (baseline / adversary training)."""
    return Optimizer(_torch_opt(cfg, list(model.parameters())),
                     make_schedule(cfg, steps_per_epoch))


def partition_labels(model: nn.Module, trainable_prefixes: Iterable[str],
                     freeze_rhos: bool = False) -> dict[str, str]:
    """``{parameter name: "trainable" | "frozen"}`` by the first component of
    the name; with ``freeze_rhos``, ``noise.rhos`` is frozen anyway
    (suppression runs train only the means)."""
    prefixes = tuple(trainable_prefixes)
    labels = {}
    for name, _ in model.named_parameters():
        trainable = name.split(".")[0] in prefixes
        if freeze_rhos and name == "noise.rhos":
            trainable = False
        labels[name] = "trainable" if trainable else "frozen"
    return labels


def make_cloak_optimizer(cfg: ExperimentConfig, steps_per_epoch: int,
                         model: nn.Module,
                         trainable_prefixes: Iterable[str] = ("noise",),
                         freeze_rhos: bool = False) -> Optimizer:
    """Freeze every parameter outside ``trainable_prefixes`` (for the GRL
    game: ``("noise", "gender_backbone")``) and optimize the rest."""
    labels = partition_labels(model, trainable_prefixes, freeze_rhos)
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(labels[name] == "trainable")
        if labels[name] == "trainable":
            trainable.append(p)
    return Optimizer(_torch_opt(cfg, trainable), make_schedule(cfg, steps_per_epoch))


def set_lr_scale(opt: Optimizer, scale: float) -> Optimizer:
    """Plateau scaling: every later step runs at ``schedule * scale``."""
    opt.lr_scale = float(scale)
    return opt


class PlateauScheduler:
    """Host-side ReduceLROnPlateau (mode='min'), torch's semantics as the
    reference uses them: ``patience`` epochs without a relative improvement
    of ``threshold`` in validation loss multiply the scale by ``factor``."""

    def __init__(self, patience: int = 5, factor: float = 0.2,
                 min_scale: float = 1e-4, threshold: float = 1e-4):
        self.patience = patience
        self.factor = factor
        self.min_scale = min_scale
        self.threshold = threshold
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, val_loss: float) -> float:
        """Record an epoch's validation loss; returns the current LR scale."""
        if self.best is None or val_loss < self.best * (1.0 - self.threshold):
            self.best = val_loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale
