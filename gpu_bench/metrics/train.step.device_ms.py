"""Device milliseconds of a training step: the operations launched inside
``train.step`` in the traced run's span steps, the library's eager step
(harness/spans.py).  The epoch runners replay the same operations as one
CUDA graph, so where the device sets the pace this sets the rate."""

from gpu_bench.harness.spans import device_ms_per_step


def read(rec, cell):
    return device_ms_per_step(rec.spans, "train.step")
