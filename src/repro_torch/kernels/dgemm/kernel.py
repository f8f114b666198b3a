"""ctypes wrappers of the hand-written CUDA GEMM (``csrc/dgemm.cu``), the
counterpart of the JAX package's Pallas ``matmul_pallas``.

Both wrappers take row-major 2-D tensors whose last stride is 1; the row
stride may exceed the width, so views of a larger matrix (HPL's panels
and trailing window) go in without a copy.  Inputs are float32 or
bfloat16, summed in float32.  The kernel has two block tiles, 128 x 128
x 16 (the default) and 64 x 128 x 16, chosen by ``bm``; both sum every
output element over k in the same order, so they give the same bits.
Each wrapper checks its inputs before it loads the library, launches on
the current CUDA stream without synchronising, raises if the launch was
refused, and counts the launch in ``LAUNCHES``: in all under ``"dgemm"``
and by tile under ``"dgemm_<bm>x128"``.  It takes CUDA tensors only: the
plain versions for the CPU are in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import library

# the block tiles of csrc/dgemm.cu, (rows, columns, k step)
TILES = ((128, 128, 16), (64, 128, 16))
TILE_ROWS = tuple(t[0] for t in TILES)


def tile_key(bm: int) -> str:
    return f"dgemm_{bm}x{TILES[0][1]}"


# launches of the kernel in this process (both entry points), in all and
# by tile; a run that must show it went through the kernel sets these to
# 0 before and reads them after
LAUNCHES = {"dgemm": 0, **{tile_key(bm): 0 for bm in TILE_ROWS}}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("dgemm")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gemm_launch.argtypes = [p, p, p, i64, i64, i64, i64, i64, i64,
                                i, i, i, i, i, p]
    lib.gemm_launch.restype = i
    lib.gemm_error_string.argtypes = [i]
    lib.gemm_error_string.restype = ctypes.c_char_p
    return lib


def _check_matrix(name: str, t: torch.Tensor) -> None:
    if t.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if t.stride(1) != 1 or t.stride(0) < t.shape[1]:
        raise ValueError(f"{name} must be row-major with unit column stride, "
                         f"got strides {t.stride()}")


def _check_operands(x: torch.Tensor, y: torch.Tensor) -> tuple[int, int, int]:
    _check_matrix("x", x)
    _check_matrix("y", y)
    if x.dtype != y.dtype:
        raise TypeError(f"x and y must share a dtype, got {x.dtype} and "
                        f"{y.dtype}")
    if x.shape[1] != y.shape[0]:
        raise ValueError(f"inner dimensions differ: x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}")
    return x.shape[0], x.shape[1], y.shape[1]


def _check_cuda(**tensors: torch.Tensor) -> torch.device:
    devs = {t.device for t in tensors.values()}
    dev = next(iter(devs))
    if len(devs) != 1 or dev.type != "cuda":
        raise ValueError(
            "the CUDA GEMM kernel takes tensors on one CUDA device, got "
            + ", ".join(f"{k} on {t.device}" for k, t in tensors.items()))
    return dev


def _check_tile(bm: int) -> None:
    if bm not in TILE_ROWS:
        raise ValueError(f"the GEMM kernel has tiles of {TILE_ROWS} rows, "
                         f"got bm={bm}")


def _launch(x: torch.Tensor, y: torch.Tensor, c: torch.Tensor,
            update: bool, bm: int, dev: torch.device) -> None:
    m, k, n = x.shape[0], x.shape[1], y.shape[1]
    if m == 0 or n == 0:
        return                      # nothing to write: no launch
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.gemm_launch(
        x.data_ptr(), y.data_ptr(), c.data_ptr(), m, n, k,
        x.stride(0), y.stride(0), c.stride(0), _DTYPE_CODE[x.dtype],
        _DTYPE_CODE[c.dtype], int(update), bm, dev.index, stream)
    if err:
        msg = lib.gemm_error_string(err).decode()
        raise RuntimeError(f"dgemm launch failed: {msg} (cudaError {err})")
    LAUNCHES["dgemm"] += 1
    LAUNCHES[tile_key(bm)] += 1


def dgemm(x: torch.Tensor, y: torch.Tensor,
          out_dtype: torch.dtype | None = None, *,
          bm: int = TILE_ROWS[0]) -> torch.Tensor:
    """``x @ y`` summed in float32, returned in ``out_dtype`` (default
    ``x.dtype``): x (M, K), y (K, N), float32 or bfloat16, on the
    ``bm``-row tile (128 or 64)."""
    m, _, n = _check_operands(x, y)
    _check_tile(bm)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    dev = _check_cuda(x=x, y=y)
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    _launch(x, y, out, False, bm, dev)
    return out


def dgemm_update_(c: torch.Tensor, x: torch.Tensor, y: torch.Tensor, *,
                  bm: int = TILE_ROWS[0]) -> torch.Tensor:
    """In place ``c -= x @ y``: the product is summed in float32, then
    subtracted from ``c`` in float32 and rounded once to ``c.dtype``.
    ``c`` (M, N) must not overlap ``x`` or ``y``.  ``bm`` is the tile's
    rows, as for :func:`dgemm`.  Returns ``c``."""
    m, _, n = _check_operands(x, y)
    _check_tile(bm)
    _check_matrix("c", c)
    if tuple(c.shape) != (m, n):
        raise ValueError(f"c must have shape {(m, n)}, got {tuple(c.shape)}")
    dev = _check_cuda(c=c, x=x, y=y)
    _launch(x, y, c, True, bm, dev)
    return c
