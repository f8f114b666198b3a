"""ctypes wrapper of the hand-written CUDA RMSNorm (``csrc/rmsnorm.cu``),
the counterpart of the JAX package's Pallas ``rmsnorm_pallas``.

The wrapper takes a 2-D ``x`` (rows, d) whose last stride is 1 (the row
stride may exceed d) and a ``w`` (d,), each float32 or bfloat16.  It
checks its inputs before it loads the library, allocates the output with
``torch.empty``, launches on the current CUDA stream without
synchronising, raises if the launch was refused, and counts the launch in
``LAUNCHES``.  It takes CUDA tensors only: the plain version for the CPU
is in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import library

# launches of the kernel in this process; a run that must show it went
# through the kernel sets this to 0 before and reads it after
LAUNCHES = {"rmsnorm": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("rmsnorm")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rmsnorm_launch.argtypes = [p, p, p, i64, i64, i64, i, i,
                                   ctypes.c_float, i, p]
    lib.rmsnorm_launch.restype = i
    lib.rmsnorm_error_string.argtypes = [i]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def _check_cuda(**tensors: torch.Tensor) -> torch.device:
    devs = {t.device for t in tensors.values()}
    dev = next(iter(devs))
    if len(devs) != 1 or dev.type != "cuda":
        raise ValueError(
            "the CUDA RMSNorm kernel takes tensors on one CUDA device, got "
            + ", ".join(f"{k} on {t.device}" for k, t in tensors.items()))
    return dev


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2, -1) + eps) * w`` per row of x (rows, d),
    float32 math, returned contiguous in ``x.dtype``."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (rows, d), got shape "
                         f"{tuple(x.shape)}")
    rows, d = x.shape
    if tuple(w.shape) != (d,):
        raise ValueError(f"w must have shape ({d},), got {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if d and (x.stride(1) != 1 or (rows > 1 and x.stride(0) < d)):
        raise ValueError(f"x must be row-major with unit column stride, "
                         f"got strides {x.stride()}")
    if w.stride(0) != 1:
        raise ValueError("w must be contiguous")
    dev = _check_cuda(x=x, w=w)
    out = torch.empty((rows, d), dtype=x.dtype, device=dev)
    if rows == 0 or d == 0:
        return out                   # nothing to write: no launch
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rmsnorm_launch(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
        max(x.stride(0), d), _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype],
        eps, dev.index, stream)
    if err:
        msg = lib.rmsnorm_error_string(err).decode()
        raise RuntimeError(f"rmsnorm launch failed: {msg} (cudaError {err})")
    LAUNCHES["rmsnorm"] += 1
    return out
