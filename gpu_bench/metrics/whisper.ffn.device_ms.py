"""Device milliseconds a training step under ``whisper.ffn`` (each layer's
LN2, fc1, GELU, fc2 and residual, in each Whisper forward of the step), in
the traced run's span steps, the library's eager step (harness/spans.py);
nothing where the program opens no such span."""

from gpu_bench.harness.spans import device_ms_per_step


def read(rec, cell):
    return device_ms_per_step(rec.spans, "whisper.ffn")
