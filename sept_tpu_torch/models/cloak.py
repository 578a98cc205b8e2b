"""The cloak in PyTorch: the learned per-cell Gaussian noise layer and the
two cloaked models of training.

Counterparts of ``sept_tpu/models/cloak.py``: ``CloakNoise`` (the
reference's ``cloak_noise``), ``CloakedModel`` (noise before a frozen
backbone) and ``CloakedModelGRL`` (noise before a frozen emotion backbone and
a trainable gender adversary behind a gradient-reversal layer).  Parameters
``locs`` (mu, init 0) and ``rhos`` (init -2) have the reference's (1, win_len, n_feats) layout, so its ``intermed.*``
tensors and :func:`sept_tpu_torch.compat.from_jax.cloak_noise_state_dict`
load as they are.

- scales: ``(1 + tanh(rho)) / 2 * (max - min) + min``;
- epsilon is N(0, 0.1): std 0.1, not 1, so the noise std is 0.1 * scales;
- a suppression mask gates the input and epsilon, never ``locs``:
  ``x * mask + locs + scales * eps * mask``.

The draw comes from the ``torch.Generator`` the caller passes, or the caller
passes ``eps`` itself (the tests inject the JAX draw this way: torch's and
JAX's generators give different numbers from one seed).

The frozen backbones always run in eval mode (BN running statistics, no
dropout), whatever mode the cloaked model is in; gradients still flow
through them into the noise parameters.  Freezing the parameters is the
optimizer's business (``sept_tpu_torch.train.optim.make_cloak_optimizer``).
The cloaked models take NCHW windows (B, 1, win_len, n_feats) and the
epsilon draw of the step (``CloakNoise.draw_eps``); ``noise_sign`` flips it.
The backbones may compute in bf16 (``Conv2dBiRNN(compute_dtype=...)``): the
noise and ``x + noise`` stay f32 and block 1's K1 rounds the noised input,
as in the JAX package.  ``global_feature`` (B, 88) goes to every backbone
as it is (no noise, no gradient reversal), for backbones built with
``global_dim``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from sept_tpu_torch.models.backbone import Conv2dBiRNN, DropoutDraws
from sept_tpu_torch.ops.grl import gradient_reversal

__all__ = ["CloakNoise", "CloakedModel", "CloakedModelGRL"]


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

    def draw_eps(self, generator: torch.Generator) -> torch.Tensor:
        """One draw of epsilon ~ N(0, eps_std), (1, win, feats), on the
        generator's device."""
        return self.eps_std * torch.randn(self.rhos.shape, generator=generator,
                                          device=generator.device)

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
            eps = sign * self.draw_eps(generator)
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


def _noised(noise: CloakNoise, x, mask, noise_sign, eps):
    """(B, 1, T, D) -> the noised windows, one draw for the whole batch."""
    return noise(x[:, 0], mask=mask, eps=noise_sign * eps)[:, None]


class CloakedModel(nn.Module):
    """Noise layer before a frozen backbone: (B, 1, T, D) -> (logits,
    noisy), ``noisy`` detached (``two_d_cnn_lstm_syn``)."""

    def __init__(self, backbone: Conv2dBiRNN, win_len: int = 200, n_feats: int = 128,
                 min_scale: float = 0.01, max_scale: float = 10.0):
        super().__init__()
        self.noise = CloakNoise(win_len, n_feats, min_scale, max_scale)
        self.backbone = backbone

    def train(self, mode: bool = True):
        super().train(mode)
        self.backbone.eval()
        return self

    def forward(self, x: torch.Tensor, eps: torch.Tensor,
                mask: Optional[torch.Tensor] = None, pooling: Optional[str] = "mean",
                noise_sign: float = 1.0, global_feature: Optional[torch.Tensor] = None):
        noised = _noised(self.noise, x, mask, noise_sign, eps)
        return (self.backbone(noised, pooling=pooling, global_feature=global_feature),
                noised.detach())


class CloakedModelGRL(nn.Module):
    """Noise, a frozen emotion backbone (eval mode) and a gender backbone
    behind ``gradient_reversal(noised, grl_lambda)`` in this module's mode
    (``two_d_cnn_lstm_syn_with_grl``): (B, 1, T, D) -> (emotion logits,
    gender logits, noisy).  Both branches see the same noise draw."""

    def __init__(self, emotion_backbone: Conv2dBiRNN, gender_backbone: Conv2dBiRNN,
                 grl_lambda: float = 0.1, win_len: int = 200, n_feats: int = 128,
                 min_scale: float = 0.01, max_scale: float = 10.0):
        super().__init__()
        self.noise = CloakNoise(win_len, n_feats, min_scale, max_scale)
        self.emotion_backbone = emotion_backbone
        self.gender_backbone = gender_backbone
        self.grl_lambda = grl_lambda

    def train(self, mode: bool = True):
        super().train(mode)
        self.emotion_backbone.eval()
        return self

    def forward(self, x: torch.Tensor, eps: torch.Tensor,
                mask: Optional[torch.Tensor] = None, pooling: Optional[str] = "mean",
                noise_sign: float = 1.0, dropout: Optional[DropoutDraws] = None,
                update_stats: bool = True, global_feature: Optional[torch.Tensor] = None):
        """``dropout`` and ``update_stats`` go to the gender backbone (see
        ``Conv2dBiRNN.encode``)."""
        noised = _noised(self.noise, x, mask, noise_sign, eps)
        emo = self.emotion_backbone(noised, pooling=pooling, global_feature=global_feature)
        gen = self.gender_backbone(gradient_reversal(noised, self.grl_lambda),
                                   pooling=pooling, dropout=dropout,
                                   update_stats=update_stats, global_feature=global_feature)
        return emo, gen, noised.detach()
