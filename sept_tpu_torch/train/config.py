"""Experiment configuration of the training slice.

Counterpart of ``sept_tpu/train/config.py``: ``ExperimentConfig`` limited to
the fields the training slice reads (the compute dtype that the caller turns
into the models' ``compute_dtype`` with
:func:`sept_tpu_torch.models.compute_dtype`, the optimizer and its schedule
in :mod:`sept_tpu_torch.train.optim`, the cloak's weights and noise bounds
and the saliency-alignment weight that the caller hands to the cloak models
and step functions), and ``preset`` with the four presets of the JAX
package, cut to those fields (each mirrors one reference entry point's
defaults, including the per-script learning-rate differences).  The data,
model, epoch-loop, plateau and early-stopping fields come with the modules
that read them.  Left out for good: ``conv_backend`` (the port has one
block-1 path, its kernels in both dtypes), ``remat`` and ``prng_impl``.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ExperimentConfig", "preset"]


@dataclasses.dataclass
class ExperimentConfig:
    # "float32" or "bfloat16" (the CLIs' --compute_dtype): blocks 1-3 and the
    # GRU compute in it, parameters and running statistics stay f32
    compute_dtype: str = "float32"

    # optimization
    optimizer: str = "sgd"
    learning_rate: float = 1e-4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    # StepLR (sgd): baselines step 5 gamma 0.5, cloak step 10
    lr_step_epochs: int = 5
    lr_gamma: float = 0.5
    # scheduler.step() calls per epoch: the baseline and plain-cloak
    # trainers step after both the train and the validate pass, the GRL
    # trainer once (see optim.make_schedule)
    lr_sched_steps_per_epoch: int = 2

    # cloak
    scale_lambda: float = 0.0
    grl_lambda: float = 0.1
    gender_lambda: float = 0.1
    noise_min_scale: float = 0.01
    noise_max_scale: float = 10.0
    antithetic_noise: bool = False
    # weight of the GRL game's saliency-alignment term (a framework extension,
    # steps.saliency_alignment_loss); 0 = the reference's behavior
    saliency_align: float = 0.0


_PRESETS = {
    # training_adversary_baselines.py: SGD lr 1e-4 StepLR(5, 0.5)
    "baseline": dict(optimizer="sgd", learning_rate=1e-4, lr_step_epochs=5),
    "adversary": dict(optimizer="sgd", learning_rate=1e-4, lr_step_epochs=5),
    # training_cloak.py: SGD lr 1e-3 StepLR(10, 0.5)
    "cloak": dict(optimizer="sgd", learning_rate=1e-3, lr_step_epochs=10,
                  scale_lambda=0.1),
    # training_cloak_with_grl.py: the cloak StepLR stepped once per epoch;
    # the GRL game
    "cloak_grl": dict(optimizer="sgd", learning_rate=1e-3, lr_step_epochs=10,
                      scale_lambda=0.1, grl_lambda=0.1, gender_lambda=0.1,
                      lr_sched_steps_per_epoch=1),
}


def preset(name: str, **overrides) -> ExperimentConfig:
    cfg = dict(_PRESETS[name])
    cfg.update(overrides)
    return ExperimentConfig(**cfg)
