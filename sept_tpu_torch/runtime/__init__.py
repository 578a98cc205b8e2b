"""Native IO of the port: the WAV decoder (``csrc/septio.cpp``) via ctypes."""

from sept_tpu_torch.runtime.wavio import (
    decode_batch,
    decode_wav,
    have_native,
    narrow_pcm16,
    write_wav,
)

__all__ = ["decode_batch", "decode_wav", "have_native", "narrow_pcm16", "write_wav"]
