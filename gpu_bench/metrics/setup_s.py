"""Set-up seconds: process start to the window's first unit of work
(CUDA start, kernels loaded or built, data made, weights, the checked
steps and the warm-up of the validation pass)."""


def read(rec, cell):
    return rec.setup_s
