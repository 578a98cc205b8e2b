"""The cloak's learned per-cell Gaussian noise layer in PyTorch.

Counterpart of ``sept_tpu/models/cloak.py::CloakNoise`` (the reference's
``cloak_noise``).  Parameters ``locs`` (mu, init 0) and ``rhos`` (init -2)
have the reference's (1, win_len, n_feats) layout, so its ``intermed.*``
tensors and :func:`sept_tpu_torch.compat.from_jax.cloak_noise_state_dict`
load as they are.

- scales: ``(1 + tanh(rho)) / 2 * (max - min) + min``;
- epsilon is N(0, 0.1): std 0.1, not 1, so the noise std is 0.1 * scales;
- a suppression mask gates the input and epsilon, never ``locs``:
  ``x * mask + locs + scales * eps * mask``.

The draw comes from the ``torch.Generator`` the caller passes, or the caller
passes ``eps`` itself (the tests inject the JAX draw this way: torch's and
JAX's generators give different numbers from one seed).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

__all__ = ["CloakNoise"]


class CloakNoise(nn.Module):
    def __init__(self, win_len: int = 200, n_feats: int = 128,
                 min_scale: float = 0.01, max_scale: float = 10.0,
                 eps_std: float = 0.1):
        super().__init__()
        self.min_scale, self.max_scale, self.eps_std = min_scale, max_scale, eps_std
        self.locs = nn.Parameter(torch.zeros(1, win_len, n_feats))
        self.rhos = nn.Parameter(torch.full((1, win_len, n_feats), -2.0))

    def scales(self) -> torch.Tensor:
        """tanh-squashed noise scale in [min_scale, max_scale], (1, win, feats)."""
        return (1.0 + torch.tanh(self.rhos)) / 2.0 * (
            self.max_scale - self.min_scale) + self.min_scale

    def sample_noise(self, mask: Optional[torch.Tensor] = None,
                     sign: float = 1.0,
                     generator: Optional[torch.Generator] = None,
                     eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``locs + scales * eps [* mask]``.  ``eps`` defaults to
        ``sign * eps_std * N(0, 1)`` drawn from ``generator`` on the
        generator's device; a given ``eps`` already carries the 0.1 std and
        the sign."""
        if eps is None:
            if generator is None:
                raise ValueError("CloakNoise needs a torch.Generator or eps")
            eps = sign * self.eps_std * torch.randn(
                self.rhos.shape, generator=generator, device=generator.device)
        eps = eps.to(self.rhos.device, torch.float32)
        if mask is not None:
            eps = eps * mask
        return self.locs + self.scales() * eps

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                sign: float = 1.0, generator: Optional[torch.Generator] = None,
                eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (N, win_len, n_feats); one noise draw shared by the whole call."""
        noise = self.sample_noise(mask, sign, generator, eps)
        return x + noise if mask is None else x * mask + noise
