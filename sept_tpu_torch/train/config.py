"""Experiment configuration of the port.

Counterpart of ``sept_tpu/train/config.py``: ``ExperimentConfig`` with the
fields the port reads (data geometry, the model, the fold loop's epochs,
plateau and early stopping, the optimizer and its schedule in
:mod:`sept_tpu_torch.train.optim`, the cloak's weights, noise bounds,
suppression and mask direction, the compute dtype that the caller turns
into the models' ``compute_dtype`` with
:func:`sept_tpu_torch.models.compute_dtype`, the feature type, shift, norm
and augmentation that the preprocess CLI assembles folds with, the seed, the
fold count and the output directory), and ``preset`` with the four presets
of the JAX package, cut to those fields (each mirrors one reference entry
point's defaults, including the per-script learning rates, epoch counts and
plateau settings).  Left out for good: ``conv_backend`` (the port has one block-1 path, its kernels
in both dtypes), ``remat``, ``prng_impl`` and ``filter_size`` (no model
reads it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ExperimentConfig", "preset"]


@dataclasses.dataclass
class ExperimentConfig:
    # data
    dataset: str = "iemocap"
    feature_type: str = "mel_spec"  # "mel_spec" or "mfcc"
    feature_len: int = 128  # --input_spec_size
    win_len: int = 200
    shift: bool = True  # slide windows over training utterances (else one)
    norm: str = "znorm"  # per-speaker "znorm" or "min_max"
    aug: Optional[str] = "emotion"  # balance the training split on "emotion" / "gender"
    adv: bool = False  # train on the adversary splits

    # model
    model_type: str = "2d-cnn-lstm"
    pred: str = "emotion"
    hidden_size: int = 64
    attention_size: int = 128
    att: Optional[str] = None
    # concatenate the 88-dim global feature (the gemaps functionals) after
    # pooling; the models are built with global_dim=N_GLOBAL
    global_feature: bool = False
    # "float32" or "bfloat16" (the CLIs' --compute_dtype): blocks 1-3 and the
    # GRU compute in it, parameters and running statistics stay f32
    compute_dtype: str = "float32"

    # optimization
    optimizer: str = "sgd"
    learning_rate: float = 1e-4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    batch_size: int = 32
    num_epochs: int = 30
    # StepLR (sgd): baselines step 5 gamma 0.5, cloak step 10
    lr_step_epochs: int = 5
    lr_gamma: float = 0.5
    # scheduler.step() calls per epoch: the baseline and plain-cloak
    # trainers step after both the train and the validate pass, the GRL
    # trainer once (see optim.make_schedule)
    lr_sched_steps_per_epoch: int = 2
    # ReduceLROnPlateau (adam)
    plateau_patience: int = 5
    plateau_factor: float = 0.2
    early_stop_patience: int = 10
    min_select_epoch: int = 10  # best-by-validation accuracy only after epoch 10
    # the baseline trainer breaks on early stopping only under Adam, the
    # cloak trainers always
    early_stop_with_sgd: bool = True

    # cloak
    scale_lambda: float = 0.0
    suppression_ratio: int = 0
    grl: bool = False
    grl_lambda: float = 0.1
    gender_lambda: float = 0.1
    noise_min_scale: float = 0.01
    noise_max_scale: float = 10.0
    antithetic_noise: bool = False
    # weight of the GRL game's saliency-alignment term (a framework extension,
    # steps.saliency_alignment_loss); 0 = the reference's behavior
    saliency_align: float = 0.0
    # percentile-mask direction of suppressed cloak training: "train" (the
    # reference: zero the top-r% noisiest cells) or "eval" (the sweep's mask)
    mask_direction: str = "train"

    # run
    seed: int = 8
    n_folds: int = 5
    output_dir: str = "results"

    @property
    def shift_len(self) -> int:
        return self.win_len // 4


_PRESETS = {
    # training_adversary_baselines.py: SGD lr 1e-4 StepLR(5, 0.5), 100
    # epochs; adam's Plateau(patience=3, factor=0.2)
    "baseline": dict(optimizer="sgd", learning_rate=1e-4, lr_step_epochs=5,
                     num_epochs=100, pred="emotion", adv=False,
                     early_stop_with_sgd=False, plateau_patience=3, plateau_factor=0.2),
    "adversary": dict(optimizer="sgd", learning_rate=1e-4, lr_step_epochs=5,
                      num_epochs=100, pred="gender", adv=True,
                      early_stop_with_sgd=False, plateau_patience=3, plateau_factor=0.2),
    # training_cloak.py: SGD lr 1e-3 StepLR(10, 0.5), 30 epochs; adam's
    # Plateau(patience=5, factor=0.2)
    "cloak": dict(optimizer="sgd", learning_rate=1e-3, lr_step_epochs=10,
                  num_epochs=30, pred="emotion", scale_lambda=0.1,
                  plateau_patience=5, plateau_factor=0.2),
    # training_cloak_with_grl.py: the cloak StepLR stepped once per epoch;
    # Plateau(patience=3, factor=0.5); the GRL game
    "cloak_grl": dict(optimizer="sgd", learning_rate=1e-3, lr_step_epochs=10,
                      num_epochs=30, pred="emotion", scale_lambda=0.1,
                      grl=True, grl_lambda=0.1, gender_lambda=0.1,
                      lr_sched_steps_per_epoch=1, plateau_patience=3, plateau_factor=0.5),
}


def preset(name: str, **overrides) -> ExperimentConfig:
    cfg = dict(_PRESETS[name])
    cfg.update(overrides)
    return ExperimentConfig(**cfg)
