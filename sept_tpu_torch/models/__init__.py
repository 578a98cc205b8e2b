"""PyTorch models of the port: Conv2dBiRNN and the cloak (noise layer and the
cloaked training models)."""

import torch

from sept_tpu_torch.models.backbone import (
    NUM_EMO_CLASSES,
    NUM_GENDER_CLASSES,
    Conv2dBiRNN,
)
from sept_tpu_torch.models.cloak import CloakedModel, CloakedModelGRL, CloakNoise

__all__ = [
    "NUM_EMO_CLASSES",
    "NUM_GENDER_CLASSES",
    "CloakNoise",
    "CloakedModel",
    "CloakedModelGRL",
    "Conv2dBiRNN",
    "build_backbone",
    "compute_dtype",
    "pooling_for",
]

_PORTED = ("cnn-lstm-att", "2d-cnn-lstm")
_NOT_YET = ("deep-2d-cnn-lstm", "1d-cnn-lstm-att", "2d-cnn")


def build_backbone(model_type: str, **kwargs) -> Conv2dBiRNN:
    """Model factory over the reference trainers' --model_type switch."""
    if model_type in _PORTED:
        return Conv2dBiRNN(**kwargs)
    if model_type in _NOT_YET:
        raise NotImplementedError(
            f"model_type {model_type!r} is not ported to PyTorch yet; it is "
            "queued in ROADMAP.md")
    raise ValueError(f"unknown model_type: {model_type!r}")


def compute_dtype(name: str) -> torch.dtype:
    """--compute_dtype value ("float32", "bfloat16") -> the models'
    ``compute_dtype``."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def pooling_for(model_type: str):
    """Temporal pooling per --model_type: the 'deep' variants flatten the RNN
    sequence (None), every other type mean-pools."""
    return None if "deep" in model_type else "mean"
