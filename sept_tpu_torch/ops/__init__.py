"""Tensor ops of the port: the audio frontend, the functionals, the
gradient reversal and the CUDA kernel wrappers.  The JAX package's Pallas
entries have their counterparts in the wrappers' modules:
``pallas_mel_spectrogram`` is :func:`sept_tpu_torch.ops.mel.mel_db` (and
``mel_db_bf16``), ``pallas_mfcc`` is :func:`sept_tpu_torch.ops.mfcc.fused_mfcc`."""

from sept_tpu_torch.ops.egemaps import (
    N_GEMAPS,
    egemaps_functionals,
    egemaps_functionals_batch,
)
from sept_tpu_torch.ops.emobase import (
    N_EMOBASE,
    emobase_functionals,
    emobase_functionals_batch,
)
from sept_tpu_torch.ops.frontend import (
    amplitude_to_db,
    create_dct,
    frame_signal,
    hann_window,
    hz_to_mel,
    mel_spectrogram,
    mel_to_hz,
    melscale_fbanks,
    mfcc,
    mfcc_with_deltas,
    np_gradient,
    stft_power,
)
from sept_tpu_torch.ops.grl import gradient_reversal
from sept_tpu_torch.ops.mel import mel_db, mel_db_bf16
from sept_tpu_torch.ops.mfcc import fused_mfcc

__all__ = [
    "amplitude_to_db",
    "create_dct",
    "frame_signal",
    "N_GEMAPS",
    "N_EMOBASE",
    "egemaps_functionals",
    "egemaps_functionals_batch",
    "emobase_functionals",
    "emobase_functionals_batch",
    "fused_mfcc",
    "gradient_reversal",
    "hann_window",
    "hz_to_mel",
    "mel_db",
    "mel_db_bf16",
    "mel_to_hz",
    "mel_spectrogram",
    "melscale_fbanks",
    "mfcc",
    "mfcc_with_deltas",
    "np_gradient",
    "stft_power",
]
