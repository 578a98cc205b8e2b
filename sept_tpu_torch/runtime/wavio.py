"""ctypes bindings of the native WAV decoder ``csrc/septio.cpp``.

Counterpart of ``sept_tpu/runtime/wavio.py``: RIFF parse (PCM 8/16/24/32-bit
int, float32 and float64), mono mix, Kaiser-windowed-sinc resampling to
16 kHz, a pthread pool for batch decode, and a PCM16 writer.  The port
compiles the same ``csrc/septio.cpp``, unedited, with the same flags, into a
directory of its own, ``build/torch_septio/`` (git-ignored), one library
per hash of the source and flags; it never loads the JAX package's
``build/libseptio.so``.  Nothing is built while the module is imported: the
first call builds.  There is no fallback decoder: where the JAX package
quietly decodes with a numpy linear resampler when the library does not
build (a different feature store from the same corpus), the port raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["build", "have_native", "decode_wav", "decode_batch", "narrow_pcm16", "write_wav"]

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "septio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_septio"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-lpthread", "-lm")
_COMPILERS = ("c++", "g++", "clang++")

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}


def _lib_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS + _LIBS).encode())
    return BUILD_DIR / f"libseptio-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/septio.cpp`` if its library is missing; returns the
    library's path.  Raises when no C++ compiler is on ``PATH`` or the build
    fails."""
    out = _lib_path()
    if out.exists():
        return out
    cc = next((c for c in map(shutil.which, _COMPILERS) if c), None)
    if cc is None:
        raise RuntimeError(
            f"no C++ compiler ({', '.join(_COMPILERS)}) on PATH: the port's WAV "
            "decoder compiles csrc/septio.cpp on first use and has no fallback")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a per-process name renamed into place: a concurrent process never
    # loads a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cc, *_FLAGS, "-o", str(tmp), str(_SRC), *_LIBS],
                          capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the WAV decoder failed ({cc}, exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    with _lock:
        path = build()
        lib = _libs.get(path)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            lib.septio_decode.restype = ctypes.c_int
            lib.septio_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ]
            lib.septio_decode_batch.restype = None
            lib.septio_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
                ctypes.c_int,
            ]
            lib.septio_write_wav.restype = ctypes.c_int
            lib.septio_write_wav.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                ctypes.c_int,
            ]
            _libs[path] = lib
        return lib


def have_native() -> bool:
    """Whether the native decoder builds and loads (a probe: the decoders
    still raise without it)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def decode_wav(path: str, target_sr: int = 16000, max_seconds: float = 120.0):
    """Decode one WAV to mono float32 at ``target_sr``; returns (wave, sr).
    The output holds at most ``max_seconds * target_sr`` samples.  Raises
    ``IOError`` on a file the decoder refuses (malformed, compressed)."""
    lib = _load()
    max_len = int(max_seconds * target_sr)
    buf = np.zeros(max_len, dtype=np.float32)
    out_len = ctypes.c_int64(0)
    out_sr = ctypes.c_int(0)
    ok = lib.septio_decode(
        os.fsencode(path), target_sr,
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_len,
        ctypes.byref(out_len), ctypes.byref(out_sr),
    )
    if not ok:
        raise IOError(f"septio failed to decode {path}")
    return buf[: out_len.value].copy(), out_sr.value


def decode_batch(paths: list[str], target_sr: int = 16000, max_seconds: float = 120.0,
                 n_threads: int = 8):
    """Threaded batch decode; returns (mat (N, max_len) float32, lengths (N,)
    int64).  A file the decoder refuses is a row of length 0."""
    lib = _load()
    max_len = int(max_seconds * target_sr)
    mat = np.zeros((len(paths), max_len), dtype=np.float32)
    lengths = np.zeros(len(paths), dtype=np.int64)
    rates = np.zeros(len(paths), dtype=np.int32)
    names = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
    lib.septio_decode_batch(
        names, len(paths), target_sr,
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_len,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    return mat, lengths


def narrow_pcm16(wave: np.ndarray) -> np.ndarray:
    """``wave`` as int16 iff the narrowing is lossless, else unchanged.

    A 16-bit PCM source decoded at the target rate comes out as exactly
    n/32768 floats, which narrow back to int16 bit for bit; resampled or
    mixed-down audio generally does not, and passes through as float32.
    int16 waves cross to the device at half the bytes and are scaled there
    (``ops.frontend.pcm_to_float``) to the same floats."""
    if wave.dtype == np.int16:
        return wave
    if wave.dtype != np.float32 or wave.ndim != 1:
        return wave
    scaled = wave * np.float32(32768.0)
    rounded = np.rint(scaled)
    if (
        (scaled == rounded).all()
        and (rounded >= -32768).all()
        and (rounded <= 32767).all()
    ):
        return rounded.astype(np.int16)
    return wave


def write_wav(path: str, samples: np.ndarray, sample_rate: int = 16000) -> None:
    """Write mono PCM16 (samples clipped to [-1, 1], times 32767, rounded to
    nearest)."""
    samples = np.ascontiguousarray(samples, dtype=np.float32)
    ok = _load().septio_write_wav(
        os.fsencode(path), samples.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(samples), sample_rate,
    )
    if not ok:
        raise IOError(f"septio failed to write {path}")
