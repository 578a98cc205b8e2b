"""Build and load the port's CUDA kernels.

Each ``sept_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, which is
loaded with ``ctypes``.  Libraries are keyed by a hash of their source and
flags under ``build/torch_kernels/`` (git-ignored), so an edited source
rebuilds and an unchanged one loads at once.  Nothing is built while a module
is imported: the first kernel call builds what it needs, and :func:`build`
compiles several sources at once (one ``nvcc`` process each, all started
together).  A missing ``nvcc`` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["SOURCES", "BUILD_DIR", "build", "load", "check", "stream_of",
           "require", "max_smem_per_block"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
SOURCES = ("mel", "conv_block1", "mfcc", "gru_lowp", "attention")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

# C signatures: (argtypes, restype) per exported function
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "mel": {
        "sept_mel_db": ([_P] * 6 + [_I] * 7 + [_P, _I, _P], _I),
        "sept_mel_db_smem_bytes": ([_I] * 3, _LL),
        "sept_mel_bf16_geometry": ([_P], None),
        "sept_mel_bf16_smem_bytes": ([_I], _LL),
        "sept_mel_db_bf16": ([_P] * 6 + [_I] * 6 + [_P], _I),
    },
    "mfcc": {
        "sept_floor_dct": ([_P] * 4 + [_I] * 3 + [_P], _I),
    },
    "gru_lowp": {
        "sept_gru_lowp_fwd": ([_P] * 10 + [_I] * 3 + [_P], _I),
        "sept_gru_lowp_bwd": ([_P] * 10 + [_I] * 3 + [_P], _I),
        "sept_gru_lowp_tile_elems": ([_I] * 3, _LL),
    },
    "attention": {
        "sept_attn_stats_floats": ([_I] * 4, _LL),
        "sept_attn_fwd": ([_P] * 5 + [_I] * 4 + [_F] * 2 + [_P], _I),
        "sept_attn_bwd": ([_P] * 10 + [_I] * 4 + [_F] * 2 + [_P], _I),
    },
    "conv_block1": {
        "sept_conv_stats": ([_P] * 6 + [_I] * 4 + [_P], _I),
        "sept_conv_stats_scratch_floats": ([_I] * 4, _LL),
        "sept_conv_stats_smem_bytes": ([_I], _LL),
        "sept_norm_pool": ([_P] * 4 + [_I] * 4 + [_P], _I),
        "sept_route": ([_P] * 9 + [_I] * 4 + [_P], _I),
        "sept_route_scratch_floats": ([_I] * 4, _LL),
        "sept_weight_grads": ([_P] * 10 + [_I] * 4 + [_P], _I),
        "sept_weight_grads_scratch_floats": ([_I] * 4, _LL),
        "sept_weight_grads_smem_bytes": ([_I], _LL),
        "sept_input_grad": ([_P] * 9 + [_I] * 4 + [_P], _I),
        "sept_input_grad_smem_bytes": ([_I], _LL),
        # the bf16 modes: the same arguments, bf16 storage
        "sept_conv_stats_bf16": ([_P] * 6 + [_I] * 4 + [_P], _I),
        "sept_norm_pool_bf16": ([_P] * 4 + [_I] * 4 + [_P], _I),
        "sept_route_bf16": ([_P] * 9 + [_I] * 4 + [_P], _I),
        "sept_weight_grads_bf16": ([_P] * 10 + [_I] * 4 + [_P], _I),
        "sept_input_grad_bf16": ([_P] * 9 + [_I] * 4 + [_P], _I),
    },
}


_NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), _NVCC_DEFAULT]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are compiled from sept_tpu_torch/csrc on first "
        "use and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every named source whose library is missing, all at once.

    Returns ``{name: ptxas report}`` for what was compiled in this call (the
    registers and shared memory of each kernel), and raises with the
    compiler's output if any build failed.
    """
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    reports, errors = {}, []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
            reports[name] = log
        else:
            tmp.unlink(missing_ok=True)
            errors.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.sept_error_string.argtypes = [ctypes.c_int]
            lib.sept_error_string.restype = ctypes.c_char_p
            for fn, (args, res) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        msg = lib.sept_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, what: str, shape: tuple, device: torch.device,
            dtype: torch.dtype = torch.float32):
    """Refuse anything a kernel does not take: it reads contiguous ``dtype``
    of exactly ``shape`` on ``device`` (a CUDA device)."""
    if device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {device} tensors (CUDA "
                         "tensors launch the kernel, CPU tensors take its "
                         "plain version)")
    if t.device != device:
        raise ValueError(f"{what}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def max_smem_per_block(device: torch.device) -> int:
    """Shared memory one block may opt into on ``device``."""
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", 232448))
