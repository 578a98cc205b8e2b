"""Utilities of the port: named random streams, profiling and structured
logging (the counterparts of ``sept_tpu.utils``)."""

from sept_tpu_torch.utils.logging import MetricsLogger, RunManifest
from sept_tpu_torch.utils.profiling import StepTimer, span, trace
from sept_tpu_torch.utils.prng import KeySeq, fold_in_name

__all__ = [
    "KeySeq",
    "MetricsLogger",
    "RunManifest",
    "StepTimer",
    "fold_in_name",
    "span",
    "trace",
]
