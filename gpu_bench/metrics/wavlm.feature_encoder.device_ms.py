"""Device milliseconds a training step under ``wavlm.feature_encoder`` (the
wave stem's seven convolutions with their LayerNorms and GELUs, and the
feature projection, in each WavLM forward of the step), in the traced run's
span steps, the library's eager step (harness/spans.py); nothing where the
program opens no such span."""

from gpu_bench.harness.spans import device_ms_per_step


def read(rec, cell):
    return device_ms_per_step(rec.spans, "wavlm.feature_encoder")
