"""Gradient-reversal layer: identity forward, ``-lambda * grad`` backward.

Counterpart of ``sept_tpu/ops/grl.py::gradient_reversal``.  ``lambda_`` is a
Python float, a constant hyperparameter as in the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["gradient_reversal"]


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lambda_):
        ctx.lambda_ = lambda_
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -g * ctx.lambda_, None


def gradient_reversal(x: torch.Tensor, lambda_: float = 1.0) -> torch.Tensor:
    return _GradientReversal.apply(x, float(lambda_))
