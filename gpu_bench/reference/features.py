"""Plain reference of the training windows an ingest makes from int16
utterances.

int16 / 32768 -> centre reflect pad of n_fft // 2 -> Hann-windowed frames
every ``hop`` samples (1 + len // hop of them) -> real FFT (float64)
-> power -> HTK mel bank 0-8 kHz -> 10 log10(max(., 1e-10)) -> z-norm per
speaker over every frame of that speaker's utterances (biased std, + 1e-5)
-> (win_len, n_mels) windows every ``shift_len`` frames.

The Hann window and the mel bank are built in float64 and rounded to
float32, the tables the configuration's frontend states (torchaudio's
``hann_window(periodic=True)`` and ``melscale_fbanks`` with its
``linspace(0, sr // 2, n_freqs)``); the FFT and the dB run in float64.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = ["hann", "mel_bank", "mel_db", "ingest_windows"]


@functools.lru_cache(maxsize=None)
def hann(n_fft: int) -> np.ndarray:
    k = np.arange(n_fft, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * k / n_fft)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def mel_bank(n_fft: int, n_mels: int, sample_rate: int, f_max: float = 8000.0) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) triangular HTK bank, float32."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    n_freqs = n_fft // 2 + 1
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(f_max), n_mels + 2)
    f_pts = 700.0 * (10.0 ** (m_pts / 2595.0) - 1.0)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def mel_db(waves: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(n, frames, n_mels) float64 log-mel of (n, L) int16 utterances of
    one length, on their device."""
    n_fft, hop = cfg["n_fft"], cfg["hop"]
    dev = waves.device
    x = waves.to(torch.float64) / 32768.0
    xp = torch.nn.functional.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    n_frames = 1 + waves.shape[1] // hop
    win = torch.tensor(hann(n_fft), dtype=torch.float64, device=dev)
    frames = xp.unfold(1, n_fft, hop)[:, :n_frames] * win
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    bank = torch.tensor(mel_bank(n_fft, cfg["feature_len"], cfg["sample_rate"]),
                        dtype=torch.float64, device=dev)
    return 10.0 * torch.log10(torch.clamp(power @ bank, min=1e-10))


def ingest_windows(waves: torch.Tensor, speakers: torch.Tensor, rows, cfg: dict,
                   chunk: int = 256) -> torch.Tensor:
    """Training windows of an ingest, worked out again: the log-mel of
    (N, L) int16 utterances of one length, z-normed per speaker over every
    frame of that speaker's utterances (biased std, + 1e-5), cut into
    windows every ``shift_len`` frames, utterance-major.  Returns the
    windows ``rows`` (float64)."""
    feats = torch.cat([mel_db(waves[i:i + chunk], cfg) for i in range(0, len(waves), chunk)])
    n_spk = int(speakers.max()) + 1
    d = feats.shape[-1]
    count = torch.zeros(n_spk, dtype=torch.float64, device=feats.device).index_add_(
        0, speakers, torch.full((len(waves),), float(feats.shape[1]), dtype=torch.float64,
                                device=feats.device))
    mean = torch.zeros((n_spk, d), dtype=torch.float64, device=feats.device).index_add_(
        0, speakers, feats.sum(1)) / count[:, None]
    sq = torch.zeros_like(mean).index_add_(
        0, speakers, ((feats - mean[speakers][:, None]) ** 2).sum(1))
    std = torch.sqrt(sq / count[:, None])
    win, shift = cfg["win_len"], cfg["shift_len"]
    n_win = (feats.shape[1] - win) // shift + 1
    out = []
    for r in rows:
        u, k = divmod(int(r), n_win)
        f = feats[u, k * shift:k * shift + win]
        out.append((f - mean[speakers[u]]) / (std[speakers[u]] + 1e-5))
    return torch.stack(out)
