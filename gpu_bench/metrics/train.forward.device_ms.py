"""Device milliseconds a training step under ``train.forward`` (the draws,
the backbones' forwards and the losses), in the traced run's span steps, the
library's eager step (harness/spans.py)."""

from gpu_bench.harness.spans import device_ms_per_step


def read(rec, cell):
    return device_ms_per_step(rec.spans, "train.forward")
