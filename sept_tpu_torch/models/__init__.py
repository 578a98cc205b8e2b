"""PyTorch models of the port: the model zoo (every ``--model_type`` of the
JAX package, and ``wavlm-large`` and ``whisper-large-v3``, which the JAX
package does not have) and the cloak (noise layer and the cloaked training
models)."""

import inspect

import torch

from sept_tpu_torch.models.backbone import (
    N_GLOBAL,
    NUM_EMO_CLASSES,
    NUM_GENDER_CLASSES,
    Conv2dBiRNN,
    DeepConv2dBiRNN,
    OneDConvNet,
    PlainConv2d,
)
from sept_tpu_torch.models.cloak import CloakedModel, CloakedModelGRL, CloakNoise
from sept_tpu_torch.models.wavlm import WavLM
from sept_tpu_torch.models.whisper import Whisper

__all__ = [
    "N_GLOBAL",
    "NUM_EMO_CLASSES",
    "NUM_GENDER_CLASSES",
    "CloakNoise",
    "CloakedModel",
    "CloakedModelGRL",
    "Conv2dBiRNN",
    "DeepConv2dBiRNN",
    "OneDConvNet",
    "PlainConv2d",
    "WavLM",
    "Whisper",
    "build_backbone",
    "compute_dtype",
    "pooling_for",
]

_CLASSES = {
    "cnn-lstm-att": Conv2dBiRNN,
    "2d-cnn-lstm": Conv2dBiRNN,
    "deep-2d-cnn-lstm": DeepConv2dBiRNN,
    "1d-cnn-lstm-att": OneDConvNet,
    "2d-cnn": PlainConv2d,
    "wavlm-large": WavLM,
    "whisper-large-v3": Whisper,
}
# Knobs that only some model types take: build_backbone drops these (and
# only these) for a type whose class lacks them, so that the trainers can
# pass one knob set for any --model_type; any other unknown knob raises.
# The JAX package's family knobs, with ``compute_dtype`` for its ``dtype``
# (so a bf16 run of 1d-cnn-lstm-att or 2d-cnn trains in f32, as there) and
# ``bn_group`` for its ``bn_axis_name`` (so those two types keep plain BN
# under data parallelism, as there), without its ``conv_backend`` and
# ``remat``, which the port does not have; plus the window geometry, which
# flax reads off the input and torch's modules need when they are built.
_FAMILY_KNOBS = frozenset({"hidden_size", "rnn_cell", "att", "attention_size",
                           "compute_dtype", "feature_len", "win_len", "bn_group"})


def build_backbone(model_type: str, **kwargs):
    """Model factory over the reference trainers' --model_type switch."""
    cls = _CLASSES.get(model_type)
    if cls is None:
        raise ValueError(f"unknown model_type: {model_type!r}")
    fields = set(inspect.signature(cls.__init__).parameters)
    return cls(**{k: v for k, v in kwargs.items()
                  if k in fields or k not in _FAMILY_KNOBS})


def compute_dtype(name: str) -> torch.dtype:
    """--compute_dtype value ("float32", "bfloat16") -> the models'
    ``compute_dtype``."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def pooling_for(model_type: str):
    """Temporal pooling per --model_type: the 'deep' variants flatten the RNN
    sequence (None), every other type mean-pools.  Training, evaluation and
    serving must all use the same pooling, or the deep model's ``dense1``
    gets the wrong width."""
    return None if "deep" in model_type else "mean"
