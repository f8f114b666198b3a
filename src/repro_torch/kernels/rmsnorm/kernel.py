"""ctypes wrapper of the hand-written CUDA RMSNorm (``csrc/rmsnorm.cu``),
the counterpart of the JAX package's Pallas ``rmsnorm_pallas``.

The wrapper takes a 2-D ``x`` (rows, d) whose last stride is 1 (the row
stride may exceed d) and a ``w`` (d,), each float32 or bfloat16.  It
checks its inputs before it loads the library, allocates the output with
``torch.empty``, launches on the current CUDA stream without
synchronising, raises if the launch was refused, and counts the launch in
``LAUNCHES``, and by shape in ``SHAPE_LAUNCHES``.  It takes CUDA tensors
only: the plain version for the CPU is in ``ref.py``.  ``variant`` says
which of the library's two kernels a call runs (chosen from the shape and
the alignment alone), and ``variant_launches`` counts the library's
launches of each.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import torch

from repro_torch.kernels._build import library

# launches of the kernel in this process; a run that must show it went
# through the kernel sets this to 0 before and reads it after
LAUNCHES = {"rmsnorm": 0}
# calls on ``meta`` tensors that ``ops.rmsnorm`` gave the plain version in
# the kernel's place (the dry run's count of launches), reset with LAUNCHES
TRACED = {"rmsnorm": 0}
# the same launches by (rows, d, x dtype), reset with LAUNCHES
SHAPE_LAUNCHES: collections.Counter = collections.Counter()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the library's kernels: the generic one (a block per row), then the
# register-resident one with G = 1, 2, 4, 8 warps per row
VARIANTS = ("block", "rows_g1", "rows_g2", "rows_g4", "rows_g8")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        TRACED[k] = 0
    SHAPE_LAUNCHES.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("rmsnorm")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.rmsnorm_launch.argtypes = [p, p, p, i64, i64, i64, i, i,
                                   ctypes.c_float, i, p]
    lib.rmsnorm_launch.restype = i
    lib.rmsnorm_error_string.argtypes = [i]
    lib.rmsnorm_error_string.restype = ctypes.c_char_p
    ip = ctypes.POINTER(i)
    lib.rmsnorm_variant.argtypes = [i64, i64, i64, i, p, p, p, ip, ip]
    lib.rmsnorm_variant.restype = i
    lib.rmsnorm_variant_launches.argtypes = [ctypes.POINTER(i64)]
    lib.rmsnorm_variant_launches.restype = None
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
        x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, _row_stride(x),
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], eps, dev.index, stream)
    if err:
        msg = lib.rmsnorm_error_string(err).decode()
        raise RuntimeError(f"rmsnorm launch failed: {msg} (cudaError {err})")
    LAUNCHES["rmsnorm"] += 1
    SHAPE_LAUNCHES[rows, d, x.dtype] += 1
    return out


def _row_stride(x: torch.Tensor) -> int:
    return max(x.stride(0), x.shape[1])


def variant(x: torch.Tensor, w: torch.Tensor) -> tuple[str, int]:
    """The kernel that ``rmsnorm(x, w)`` runs, as the library chooses it
    (a name of ``VARIANTS``), and its rows per block.  The output is
    taken as 16-byte aligned, as ``torch.empty`` on a card allocates it."""
    rows, d = x.shape
    g, rpb = ctypes.c_int(), ctypes.c_int()
    kind = _lib().rmsnorm_variant(
        rows, d, _row_stride(x), _DTYPE_CODE[x.dtype], x.data_ptr(),
        w.data_ptr(), 0, ctypes.byref(g), ctypes.byref(rpb))
    if kind < 0:
        raise ValueError(f"rmsnorm takes no kernel for x {tuple(x.shape)}")
    return VARIANTS[g.value.bit_length()], rpb.value


def variant_launches() -> dict[str, int]:
    """The library's successful launches of each kernel in this process."""
    counts = (ctypes.c_int64 * len(VARIANTS))()
    _lib().rmsnorm_variant_launches(counts)
    return dict(zip(VARIANTS, counts))
