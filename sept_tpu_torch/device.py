"""Device choice and float32 precision, shared by the port's entry points."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "f32_precision"]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def f32_precision() -> None:
    """Switch TF32 off for cuBLAS and cuDNN, the counterpart of the JAX
    package's ``PARITY_PRECISION = HIGHEST``: matmuls, the blocks 2-3
    convolutions (forward and backward) and the GRU would otherwise run in
    TF32.  bf16 matmuls (the bf16 GRU's gate products) keep f32 sums: cuBLAS
    may otherwise reduce split sums in bf16, where the JAX package's bf16
    products accumulate in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
