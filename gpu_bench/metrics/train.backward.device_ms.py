"""Device milliseconds a training step under ``train.backward`` (``loss.backward()``),
in the traced run's span steps, the library's eager step (harness/spans.py)."""

from gpu_bench.harness.spans import device_ms_per_step


def read(rec, cell):
    return device_ms_per_step(rec.spans, "train.backward")
