"""Fused log-mel spectrogram: the CUDA kernel's wrapper and its plain version.

Counterpart of ``sept_tpu/ops/pallas_frontend.py::_mel_kernel`` in its f32
mode.  :func:`mel_db` launches ``csrc/mel.cu`` for a CUDA tensor and runs
:func:`mel_db_plain` for a CPU tensor; any other input raises.
"""

from __future__ import annotations

import functools

import torch

from sept_tpu_torch.ops import cuda_lib
from sept_tpu_torch.ops import frontend as F

__all__ = ["mel_db", "mel_db_plain", "AMIN"]

AMIN = 1e-10  # the AmplitudeToDB power clamp


@functools.lru_cache(maxsize=None)
def _tables(n_fft: int, n_mels: int, device: torch.device):
    """(window, cos, sin, filterbank) as f32 tensors on ``device``."""
    cos_m, sin_m = F.rdft_matrices(n_fft)
    fb = F.melscale_fbanks(n_fft // 2 + 1, 0.0, 8000.0, n_mels, 16000)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (F.hann_window(n_fft), cos_m, sin_m, fb))


def _check_geometry(padded_waves, n_frames_max, n_fft, hop):
    if padded_waves.dim() != 2:
        raise ValueError(f"padded_waves must be (B, L), got {tuple(padded_waves.shape)}")
    need = (n_frames_max - 1) * hop + n_fft
    if n_frames_max < 1 or padded_waves.shape[1] < need:
        raise ValueError(
            f"{n_frames_max} frames of n_fft {n_fft} at hop {hop} need "
            f">= {need} samples a row, got {padded_waves.shape[1]}")


def mel_db_plain(padded_waves: torch.Tensor, n_frames_max: int,
                 n_fft: int = 800, hop: int = 160,
                 n_mels: int = 128) -> torch.Tensor:
    """The same function in plain torch: frames -> Hann -> rDFT GEMMs ->
    power -> mel GEMM -> 10*log10(max(., 1e-10)), (B, T, n_mels)."""
    padded_waves = F.pcm_to_float(padded_waves)
    _check_geometry(padded_waves, n_frames_max, n_fft, hop)
    window, cos_m, sin_m, fb = _tables(n_fft, n_mels, padded_waves.device)
    frames = padded_waves.unfold(1, n_fft, hop)[:, :n_frames_max] * window
    re = frames @ cos_m
    im = frames @ sin_m
    power = re * re + im * im
    return 10.0 * torch.log10(torch.clamp(power @ fb, min=AMIN))


def mel_db(padded_waves: torch.Tensor, n_frames_max: int, n_fft: int = 800,
           hop: int = 160, n_mels: int = 128) -> torch.Tensor:
    """Log-mel spectrogram in dB (top_db None) of reflect-padded waveforms.

    ``padded_waves`` (B, L) f32, or int16 PCM (normalized here, exactly),
    each row reflect-padded by n_fft//2 at its true boundary; frame t reads
    samples [t*hop, t*hop + n_fft).  Returns (B, n_frames_max, n_mels) f32.
    Filterbank: 0-8 kHz, HTK, 16 kHz.
    """
    dev = padded_waves.device
    if dev.type == "cpu":
        return mel_db_plain(padded_waves, n_frames_max, n_fft, hop, n_mels)
    padded_waves = F.pcm_to_float(padded_waves)
    _check_geometry(padded_waves, n_frames_max, n_fft, hop)
    b, length = padded_waves.shape
    n_freq = n_fft // 2 + 1
    cuda_lib.require(padded_waves, "mel_db padded_waves", (b, length), dev)
    lib = cuda_lib.load("mel")
    max_mels = lib.sept_mel_db_max_mels()
    if n_mels > max_mels:
        raise ValueError(f"mel_db: the kernel takes at most {max_mels} mels, got {n_mels}")
    smem = lib.sept_mel_db_smem_bytes(n_fft, hop)
    if smem > cuda_lib.max_smem_per_block(dev):
        raise ValueError(f"mel_db: n_fft {n_fft} / hop {hop} need {smem} bytes "
                         "of shared memory a block, above the card's limit")
    window, cos_m, sin_m, fb = _tables(n_fft, n_mels, dev)
    out = torch.empty((b, n_frames_max, n_mels), dtype=torch.float32, device=dev)
    if b == 0:
        return out
    scratch = torch.empty(
        lib.sept_mel_db_scratch_floats(b, n_frames_max, n_freq, n_mels),
        dtype=torch.float32, device=dev)
    err = lib.sept_mel_db(
        padded_waves.data_ptr(), window.data_ptr(), cos_m.data_ptr(),
        sin_m.data_ptr(), fb.data_ptr(), out.data_ptr(), scratch.data_ptr(), b,
        length, n_frames_max, n_fft, hop, n_freq, n_mels, cuda_lib.stream_of(out))
    cuda_lib.check(lib, err, "mel_db")
    mel_db.launches += 1
    return out


mel_db.launches = 0  # kernel launches since the last reset
