"""On-device ingest: waveforms -> log-mel -> per-speaker z-norm -> training
windows, every intermediate on the device; or, for waveform models
(``frontend="wave"``), waveforms -> normalized wave windows; or, for
Whisper (``frontend="whisper"``), waveforms -> Whisper's log-mel features.

Counterpart of ``sept_tpu/data/device_pipeline.py`` (``_ingest``,
``device_ingest`` and ``DeviceDataset``).  The mel goes through
:func:`sept_tpu_torch.ops.mel.mel_db`, a CUDA mel kernel on a card, in the
mode ``frontend`` names.  Only the reflect-padded waveforms cross
host -> device.

Normalization statistics count each valid frame of a speaker once (a
centred two-pass variance: dB features make E[x^2] - E[x]^2 cancel badly in
float32); for utterances longer than one window they differ on purpose from
the host pipeline's, which counts overlapping window rows, as in the JAX
package.

The ``"wave"`` frontend (the port's own: the JAX package has no waveform
model) cuts (win_len * HOP)-sample windows every shift_len * HOP samples of
the int16 / 32768 wave, each normalized to zero mean and unit variance
(``(x - mean) / sqrt(var + 1e-7)``, the input normalization the WavLM
release applies to its Large model) and laid out as (win_len, HOP): the
windows of the mel path, frame for frame.

The ``"whisper"`` frontend (the port's own) computes the input features of
Hugging Face's ``WhisperFeatureExtractor``, one window of win_len frames a
clip: the int16 / 32768 wave cut or zero-padded to win_len * HOP samples
(480,000 for 3,000 frames: 30 s), reflect-padded by n_fft // 2 each side
(``center=True``), then the f32 mel kernel at n_fft, HOP and Whisper's
Slaney bank (``mel_db(..., mel_scale="slaney", norm="slaney")``), its dB
divided by 10 (log10 of the power clamped at 1e-10), clamped from below at
the clip's maximum minus 8, and scaled as ``(L + 4) / 4``.  No per-speaker
z-norm; every window has weight 1.
"""

from __future__ import annotations

import numpy as np
import torch

from sept_tpu_torch.data.prep import HOP, prepare_waves
from sept_tpu_torch.device import f32_precision, resolve_device
from sept_tpu_torch.ops.mel import mel_db

__all__ = ["DeviceDataset", "device_ingest", "FRONTENDS", "WAVE", "WHISPER"]

# the JAX package's frontend names -> the mel kernel's bf16 flag
FRONTENDS = {"xla": False, "pallas_bf16": True}
WAVE = "wave"  # wave windows for waveform models, no mel
WHISPER = "whisper"  # Whisper's log-mel features, one window a clip
_WAVE_EPS = 1e-7


class DeviceDataset:
    """Device-resident training windows + labels, sliceable per batch."""

    def __init__(self, windows, labels_emo, labels_gen, weight):
        self.windows = windows  # (M, win, D)
        self.labels_emo = labels_emo  # (M,) int64
        self.labels_gen = labels_gen
        self.weight = weight  # (M,) 0 for windows past an utterance's end

    def __len__(self):
        return self.windows.shape[0]

    def batch(self, idx: torch.Tensor) -> dict:
        """A batch by (device-resident) indices: spec (B, 1, win, D)."""
        return {"spec": self.windows[idx][:, None], "labels_emo": self.labels_emo[idx],
                "labels_gen": self.labels_gen[idx], "weight": self.weight[idx]}


def _ingest(padded, n_frames, speaker_idx, labels_emo, labels_gen, *, n_fft, n_mels,
            win_len, shift_len, n_speakers, max_windows, frontend="xla"):
    n = padded.shape[0]
    dev = padded.device
    tmax = int(n_frames.max())
    feats = mel_db(padded, tmax, n_fft, HOP, n_mels, bf16=FRONTENDS[frontend])  # (N, T, D)
    fmask = (torch.arange(tmax, device=dev)[None, :] < n_frames[:, None]).to(
        torch.float32)[..., None]  # (N, T, 1)

    onehot = torch.nn.functional.one_hot(speaker_idx, n_speakers).to(torch.float32)
    counts = torch.einsum("ns,nt->s", onehot, fmask[..., 0]) + 1e-8
    means = torch.einsum("ns,ntd->sd", onehot, feats * fmask) / counts[:, None]
    centered = (feats - means[speaker_idx][:, None, :]) * fmask
    sq = torch.einsum("ns,ntd->sd", onehot, centered ** 2)
    stds = torch.sqrt(torch.clamp(sq / counts[:, None], min=0.0))
    normed = (feats - means[speaker_idx][:, None, :]) / (stds[speaker_idx][:, None, :] + 1e-5)
    normed = normed * fmask

    if tmax < win_len:  # short corpus: zero frames up to one window
        normed = torch.nn.functional.pad(normed, (0, 0, 0, win_len - tmax))
    starts = torch.arange(max_windows, device=dev) * shift_len
    widx = starts[:, None] + torch.arange(win_len, device=dev)[None, :]  # (W, win)
    windows = normed[:, widx, :]  # (N, W, win, D)
    n_valid = torch.clamp((n_frames - win_len) // shift_len, min=0) + 1
    wvalid = torch.arange(max_windows, device=dev)[None, :] < n_valid[:, None]
    m = n * max_windows
    return (windows.reshape(m, win_len, n_mels),
            labels_emo.repeat_interleave(max_windows),
            labels_gen.repeat_interleave(max_windows),
            wvalid.reshape(m).to(torch.float32))


def _wave_ingest(waves, lengths, labels_emo, labels_gen, *, win_len, shift_len):
    """(N, L) int16 waves of ``lengths`` samples (zero past them) -> (windows
    (N * max_windows, win_len, HOP) f32, labels, labels, weights)."""
    size, stride = win_len * HOP, shift_len * HOP
    n = waves.shape[0]
    if waves.shape[1] < size:  # short corpus: zeros up to one window
        waves = torch.nn.functional.pad(waves, (0, size - waves.shape[1]))
    x = waves.unfold(1, size, stride).to(torch.float32) / 32768.0  # (N, W, size)
    max_windows = x.shape[1]
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).pow(2).mean(-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + _WAVE_EPS)
    n_valid = torch.clamp((lengths - size) // stride, min=0) + 1
    wvalid = torch.arange(max_windows, device=waves.device)[None, :] < n_valid[:, None]
    m = n * max_windows
    return (x.reshape(m, win_len, HOP), labels_emo.repeat_interleave(max_windows),
            labels_gen.repeat_interleave(max_windows), wvalid.reshape(m).to(torch.float32))


def _whisper_ingest(waves, labels_emo, labels_gen, *, n_fft, n_mels, win_len):
    """(N, L) int16 waves -> (features (N, win_len, n_mels) f32, labels,
    labels, weights of 1)."""
    size, pad = win_len * HOP, n_fft // 2
    x = waves[:, :size].to(torch.float32) / 32768.0
    x = torch.nn.functional.pad(x, (0, size - x.shape[1]))
    x = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    log = mel_db(x, win_len, n_fft, HOP, n_mels, mel_scale="slaney", norm="slaney") / 10.0
    log = torch.maximum(log, log.amax((1, 2), keepdim=True) - 8.0)
    return ((log + 4.0) / 4.0, labels_emo, labels_gen,
            torch.ones(waves.shape[0], device=waves.device))


def _stacked_pcm(waveforms: list[np.ndarray]):
    """int16 waves -> ((N, longest) int16 zero-padded, their lengths)."""
    if any(np.asarray(w).dtype != np.int16 for w in waveforms):
        raise ValueError("the wave and whisper frontends take int16 PCM")
    lengths = np.asarray([len(w) for w in waveforms])
    waves = np.zeros((len(waveforms), int(lengths.max())), dtype=np.int16)
    for i, w in enumerate(waveforms):
        waves[i, :len(w)] = w
    return waves, lengths


def device_ingest(waveforms: list[np.ndarray], speaker_idx: np.ndarray,
                  labels_emo: np.ndarray, labels_gen: np.ndarray, n_fft: int = 800,
                  n_mels: int = 128, win_len: int = 200, shift_len: int = 50,
                  frontend: str = "xla", device="cuda") -> DeviceDataset:
    """Waveforms (float32 or int16 PCM, 16 kHz) -> a :class:`DeviceDataset`
    of (N * max_windows, win_len, n_mels) windows on ``device``; windows past
    an utterance's last full window carry weight 0.

    ``frontend`` keeps the JAX package's names, so callers of both packages
    agree: ``"xla"`` (the parity default) runs the f32 mel kernel;
    ``"pallas_bf16"`` (the throughput mode) runs the bf16 mel kernel, bf16
    operands with f32 accumulation.  ``"wave"`` (for ``wavlm-large``) makes
    (N * max_windows, win_len, HOP) windows of the normalized wave (the
    module's docstring), int16 input only; ``n_fft`` and ``n_mels`` are not
    read.  ``"whisper"`` (for ``whisper-large-v3``) makes one (win_len,
    n_mels) window of Whisper's features a clip (the module's docstring),
    int16 input only; ``shift_len`` and ``speaker_idx`` are not read.  An
    unknown name raises ``ValueError`` (the JAX package runs the parity
    mode for it).
    """
    if frontend not in FRONTENDS and frontend not in (WAVE, WHISPER):
        raise ValueError(f"unknown frontend {frontend!r}; expected one of "
                         f"{sorted([*FRONTENDS, WAVE, WHISPER])}")
    dev = resolve_device(device)
    f32_precision()
    as_long = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.long, device=dev)  # noqa: E731
    if frontend == WHISPER:
        waves, _ = _stacked_pcm(waveforms)
        with torch.no_grad():
            out = _whisper_ingest(torch.from_numpy(waves).to(dev), as_long(labels_emo),
                                  as_long(labels_gen), n_fft=n_fft, n_mels=n_mels,
                                  win_len=win_len)
        return DeviceDataset(*out)
    if frontend == WAVE:
        waves, lengths = _stacked_pcm(waveforms)
        with torch.no_grad():
            out = _wave_ingest(torch.from_numpy(waves).to(dev), as_long(lengths),
                               as_long(labels_emo), as_long(labels_gen), win_len=win_len,
                               shift_len=shift_len)
        return DeviceDataset(*out)
    padded, n_frames = prepare_waves(waveforms, n_fft)
    tmax = int(n_frames.max())
    max_windows = max(0, (tmax - win_len) // shift_len) + 1
    n_speakers = int(np.max(speaker_idx)) + 1
    with torch.no_grad():
        windows, le, lg, wv = _ingest(
            torch.from_numpy(padded).to(dev), as_long(n_frames), as_long(speaker_idx),
            as_long(labels_emo), as_long(labels_gen), n_fft=n_fft, n_mels=n_mels,
            win_len=win_len, shift_len=shift_len, n_speakers=n_speakers,
            max_windows=max_windows, frontend=frontend)
    return DeviceDataset(windows, le, lg, wv)
