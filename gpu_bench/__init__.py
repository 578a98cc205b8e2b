"""The GPU benchmark of sept_tpu_torch: harness, plain reference, cells."""
