"""Training of the port: configuration, optimizers, steps, epoch runners and
the host fold loop (the device fold drivers are in
:mod:`sept_tpu_torch.train.device_loop`)."""

from sept_tpu_torch.train.config import ExperimentConfig, preset
from sept_tpu_torch.train.loop import (
    EarlyStopping,
    FitResult,
    fit,
    run_eval_epoch,
    run_test,
    run_train_epoch,
    speaker_weights,
)
from sept_tpu_torch.train.optim import (
    PlateauScheduler,
    make_cloak_optimizer,
    make_optimizer,
    partition_labels,
    set_lr_scale,
)
from sept_tpu_torch.train.steps import (
    TrainState,
    cloak_scales,
    init_state,
    make_baseline_step,
    make_cloak_grl_step,
    make_cloak_step,
    make_epoch_runner,
    make_eval_logits_fn,
    weighted_ce,
)

__all__ = [
    "EarlyStopping",
    "ExperimentConfig",
    "FitResult",
    "PlateauScheduler",
    "TrainState",
    "cloak_scales",
    "fit",
    "init_state",
    "make_baseline_step",
    "make_cloak_grl_step",
    "make_epoch_runner",
    "make_cloak_optimizer",
    "make_cloak_step",
    "make_eval_logits_fn",
    "make_optimizer",
    "partition_labels",
    "preset",
    "run_eval_epoch",
    "run_test",
    "run_train_epoch",
    "set_lr_scale",
    "speaker_weights",
    "weighted_ce",
]
