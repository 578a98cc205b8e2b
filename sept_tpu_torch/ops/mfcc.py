"""MFCC of padded waveform batches: the floor + DCT kernel and ``fused_mfcc``.

Counterpart of ``sept_tpu/ops/pallas_frontend.py::_floor_dct_kernel`` and
``pallas_mfcc``.  :func:`floor_dct` launches ``csrc/mfcc.cu`` for a CUDA
tensor and runs :func:`floor_dct_plain` for a CPU tensor; any other input
raises.  :func:`fused_mfcc` chains the mel kernel (either mode), the
per-utterance top_db floor and :func:`floor_dct`.
"""

from __future__ import annotations

import functools

import torch

from sept_tpu_torch.device import f32_precision, resolve_device
from sept_tpu_torch.ops import cuda_lib
from sept_tpu_torch.ops import frontend as F
from sept_tpu_torch.ops.mel import mel_db

__all__ = ["dct_basis", "floor_dct", "floor_dct_plain", "fused_mfcc"]


@functools.lru_cache(maxsize=None)
def dct_basis(n_mfcc: int, n_mels: int, device: torch.device) -> torch.Tensor:
    """DCT-II ortho basis, (n_mels, n_mfcc) f32 on ``device``."""
    # a row-major copy of create_dct's (transposed, read-only) array
    return torch.tensor(F.create_dct(n_mfcc, n_mels, "ortho"), device=device).contiguous()


def floor_dct_plain(mel_db: torch.Tensor, floor: torch.Tensor,
                    dct: torch.Tensor) -> torch.Tensor:
    """max(mel_db[r, m], floor[r]) @ dct, (rows, n_mfcc), in plain torch."""
    return torch.maximum(mel_db, floor[:, None]) @ dct


def floor_dct(mel_db: torch.Tensor, floor: torch.Tensor, dct: torch.Tensor) -> torch.Tensor:
    """Floor each row of un-floored mel dB at its own level, then the DCT.

    ``mel_db`` (rows, n_mels) f32, ``floor`` (rows,) f32, ``dct`` (n_mels,
    n_mfcc) f32, any n_mels >= 1 and n_mfcc; returns (rows, n_mfcc) f32, f32
    FMAs summed over the mels in ascending order (no TF32).
    """
    dev = mel_db.device
    if dev.type == "cpu":
        return floor_dct_plain(mel_db, floor, dct)
    if mel_db.dim() != 2 or dct.dim() != 2:
        raise ValueError(f"floor_dct: expected (rows, n_mels) and (n_mels, n_mfcc), got "
                         f"{tuple(mel_db.shape)} and {tuple(dct.shape)}")
    rows, n_mels = mel_db.shape
    n_mfcc = dct.shape[1]
    cuda_lib.require(mel_db, "floor_dct mel_db", (rows, n_mels), dev)
    cuda_lib.require(floor, "floor_dct floor", (rows,), dev)
    cuda_lib.require(dct, "floor_dct dct", (n_mels, n_mfcc), dev)
    out = torch.empty((rows, n_mfcc), dtype=torch.float32, device=dev)
    if rows == 0:
        return out
    lib = cuda_lib.load("mfcc")
    err = lib.sept_floor_dct(mel_db.data_ptr(), floor.data_ptr(), dct.data_ptr(),
                             out.data_ptr(), rows, n_mels, n_mfcc, cuda_lib.stream_of(out))
    cuda_lib.check(lib, err, "floor_dct")
    floor_dct.launches += 1
    return out


floor_dct.launches = 0  # kernel launches since the last reset


def fused_mfcc(padded_waves, n_frames_max: int, n_mfcc: int = 40, n_fft: int = 400,
               hop: int = 200, n_mels: int = 128, top_db: float | None = 80.0,
               bf16: bool = False, device="cuda") -> torch.Tensor:
    """MFCC of reflect-padded waveforms, (B, n_frames_max, n_mfcc): the
    counterpart of ``pallas_mfcc``.

    ``padded_waves`` (B, L) f32 or int16 PCM (a numpy array or a tensor),
    each row reflect-padded by n_fft//2.  The mel comes from the mel kernel
    (``bf16`` picks its mode); each utterance is floored at its max over all
    of its ``n_frames_max`` frames minus ``top_db`` (as ``pallas_mfcc``; the
    corpus featurizer floors over the valid frames only), then the DCT-II
    ortho.  With ``top_db=None`` the DCT is a plain matmul, as in JAX.
    """
    dev = resolve_device(device)
    f32_precision()
    with torch.no_grad():
        waves = torch.as_tensor(padded_waves).to(dev)
        mel = mel_db(waves, n_frames_max, n_fft, hop, n_mels, bf16=bf16)
        dct = dct_basis(n_mfcc, n_mels, dev)
        if top_db is None:
            return mel @ dct
        b = mel.shape[0]
        floor = (mel.amax(dim=(1, 2)) - top_db).repeat_interleave(n_frames_max)
        return floor_dct(mel.reshape(b * n_frames_max, n_mels), floor,
                         dct).reshape(b, n_frames_max, n_mfcc)
