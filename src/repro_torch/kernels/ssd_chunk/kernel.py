"""ctypes wrapper of the hand-written CUDA SSD-chunk kernel
(``csrc/ssd_chunk.cu``), the counterpart of the JAX package's Pallas
``ssd_chunk_pallas``.

The wrapper takes the JAX layouts: x (B, Q, H, P), dt (B, Q, H), A (H,),
B_mat and C_mat (B, Q, N), h (B, H, P, N).  x, B_mat and C_mat are float32
or bfloat16 (one dtype for the three) and may be strided views whose last
stride is 1; dt, A and h are float32.  It checks its inputs before it
loads the library, allocates y and h_new with ``torch.empty``, launches on
the current CUDA stream without synchronising, raises if the launch was
refused, and counts the launch in ``LAUNCHES``.  It takes CUDA tensors
only: the plain version for the CPU is in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import library

# launches of the kernel in this process; a run that must show it went
# through the kernel sets this to 0 before and reads it after
LAUNCHES = {"ssd_chunk": 0}
# calls on ``meta`` tensors that ``ops.ssd_chunk`` gave the plain version
# in the kernel's place (the dry run's count of launches), reset with
# LAUNCHES
TRACED = {"ssd_chunk": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The source's tiles (kTI, kTJ, kTP, kTN, kTK, kHG), threads per block
# (kThreads for float32 x, B and C on the CUDA cores, kTcThreads for
# bfloat16 on the tensor cores), row strides (kXLd, kWLd, kWsLd, kHsLd;
# ct_ld, bt_ld, raw_ld below) and limits (kMaxP, kMaxN, kMaxSmem), so that
# a shape is refused before the library is built.  The library's
# ssd_chunk_smem_bytes is the source of truth: tests/test_torch_gpu.py and
# chip_smoke.py hold smem_bytes() and these limits against it.
TI, TJ, TP, TN, TK = 64, 32, 64, 64, 32
HEAD_GROUP = 2
THREADS, TC_THREADS = 128, 256
XLD, WLD = TP + 4, TI               # float rows of h^T and of W
WSLD, HSLD = TI + 8, TK + 8         # bf16 rows of W's and h's splits
MAX_P, MAX_N = 128, 256             # the kernel's stated limits
MAX_SMEM_BYTES = 232448             # 227 KB: one Hopper block's limit


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        TRACED[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("ssd_chunk")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.ssd_chunk_launch.argtypes = [p] * 8 + [i] * 5 + [i64] * 10 + [i, i, p]
    lib.ssd_chunk_launch.restype = i
    lib.ssd_chunk_error_string.argtypes = [i]
    lib.ssd_chunk_error_string.restype = ctypes.c_char_p
    lib.ssd_chunk_smem_bytes.argtypes = [i, i, i, i]
    lib.ssd_chunk_smem_bytes.restype = i64
    return lib


def _up32(v: int) -> int:
    return (v + 31) // 32 * 32


def smem_bytes(Q: int, P: int, N: int,
               dtype: torch.dtype = torch.float32) -> int:
    """Bytes of shared memory one block takes with x, B and C of
    ``dtype``: ``layout(Q, N, esize).total`` in the source (the larger of
    the output and the state role; bfloat16 lays out the tensor-core
    roles; P does not enter)."""
    es = 2 if dtype == torch.bfloat16 else 4
    tc = es == 2
    npad = (N + 15) // 16 * 16
    ct_ld, bt_ld = TI + (8 if tc else 4), npad + (8 if tc else 4)
    raw_ld = TP + 16 // es
    threads = TC_THREADS if tc else THREADS
    common = (2 * _up32(4 * HEAD_GROUP * Q) + _up32(4 * threads)
              + (_up32(4 * (TC_THREADS // 32) * 256) if tc else 0))
    w_tc = 2 * HEAD_GROUP * 3 * max(TP * HSLD, TJ * WSLD)
    out_role = (_up32(es * npad * ct_ld) + _up32(es * TJ * bt_ld)
                + _up32(w_tc if tc else 4 * HEAD_GROUP * TJ * XLD)
                + _up32(2 * es * HEAD_GROUP * TJ * raw_ld))
    state_role = (_up32(4 * HEAD_GROUP * Q) + _up32(2 * es * TJ * raw_ld)
                  + _up32(2 * es * HEAD_GROUP * TJ * raw_ld)
                  + _up32(2 * HEAD_GROUP * 3 * TJ * WSLD if tc else 0))
    return common + max(out_role, state_role)


def admitted_smem_bytes(Q: int, P: int, N: int,
                        dtype: torch.dtype = torch.float32) -> int:
    """``smem_bytes`` where this wrapper admits the shape, else -1: what
    ``library_smem_bytes`` must return."""
    if min(Q, P, N) <= 0 or P > MAX_P or N > MAX_N:
        return -1
    b = smem_bytes(Q, P, N, dtype)
    return -1 if b > MAX_SMEM_BYTES else b


def library_smem_bytes(Q: int, P: int, N: int,
                       dtype: torch.dtype = torch.float32) -> int:
    """The built library's ``ssd_chunk_smem_bytes``: bytes of shared memory
    a launch at (Q, P, N) with x, B and C of ``dtype`` takes, or -1 where
    the launch is refused."""
    return int(_lib().ssd_chunk_smem_bytes(Q, P, N, _DTYPE_CODE[dtype]))


def _check_shape(name: str, t: torch.Tensor, shape: tuple) -> None:
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


def _check_cuda(**tensors: torch.Tensor) -> torch.device:
    devs = {t.device for t in tensors.values()}
    dev = next(iter(devs))
    if len(devs) != 1 or dev.type != "cuda":
        raise ValueError(
            "the CUDA SSD-chunk kernel takes tensors on one CUDA device, got "
            + ", ".join(f"{k} on {t.device}" for k, t in tensors.items()))
    return dev


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B_mat: torch.Tensor, C_mat: torch.Tensor,
              h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One SSD chunk for all batches and heads; returns float32
    (y (B, Q, H, P), h_new (B, H, P, N))."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, Q, H, P), got shape "
                         f"{tuple(x.shape)}")
    Bb, Q, H, P = x.shape
    N = B_mat.shape[-1]
    _check_shape("dt", dt, (Bb, Q, H))
    _check_shape("A", A, (H,))
    _check_shape("B_mat", B_mat, (Bb, Q, N))
    _check_shape("C_mat", C_mat, (Bb, Q, N))
    _check_shape("h", h, (Bb, H, P, N))
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("B_mat", B_mat), ("C_mat", C_mat)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} must share x's dtype {x.dtype}, got "
                            f"{t.dtype}")
    for name, t in (("dt", dt), ("A", A), ("h", h)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("x", x), ("B_mat", B_mat), ("C_mat", C_mat)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have unit stride in its last "
                             f"dim, got strides {t.stride()}")
    for name, t in (("A", A), ("h", h)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if P > MAX_P or N > MAX_N:
        raise ValueError(f"the kernel takes P <= {MAX_P} and N <= {MAX_N}, "
                         f"got P={P}, N={N}")
    if smem_bytes(Q, P, N, x.dtype) > MAX_SMEM_BYTES:
        raise ValueError(f"a chunk of Q={Q} needs "
                         f"{smem_bytes(Q, P, N, x.dtype)} bytes of shared "
                         f"memory, over {MAX_SMEM_BYTES}")
    if x.numel() == 0 or N == 0:
        raise ValueError(f"empty chunk: x {tuple(x.shape)}, N={N}")
    dev = _check_cuda(x=x, dt=dt, A=A, B_mat=B_mat, C_mat=C_mat, h=h)
    y = torch.empty((Bb, Q, H, P), dtype=torch.float32, device=dev)
    h_new = torch.empty((Bb, H, P, N), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ssd_chunk_launch(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_mat.data_ptr(),
        C_mat.data_ptr(), h.data_ptr(), y.data_ptr(), h_new.data_ptr(),
        Bb, Q, H, P, N, *x.stride()[:3], *dt.stride(), *B_mat.stride()[:2],
        *C_mat.stride()[:2], _DTYPE_CODE[x.dtype], dev.index, stream)
    if err:
        msg = lib.ssd_chunk_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk launch failed: {msg} "
                           f"(cudaError {err})")
    LAUNCHES["ssd_chunk"] += 1
    return y, h_new
