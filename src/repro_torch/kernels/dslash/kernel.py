"""ctypes wrappers of the hand-written CUDA D-slash kernels
(``csrc/dslash.cu``), on the re/im-split float32 layout of the JAX
package's Pallas kernels.

Each wrapper checks its inputs, allocates the output with ``torch.empty``,
launches on the current CUDA stream without synchronising, raises if the
launch was refused, and counts the launch in ``LAUNCHES``.  It takes CUDA
tensors only: the plain versions for the CPU are in ``ref.py``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import library

# launches of each kernel in this process; a run that must show it went
# through the kernels sets these to 0 before and reads them after
LAUNCHES = {"dslash_split": 0, "dslash_eo_split": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("dslash")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dslash_full_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.dslash_full_launch.restype = i
    lib.dslash_eo_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.dslash_eo_launch.restype = i
    lib.dslash_error_string.argtypes = [i]
    lib.dslash_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_cuda(**tensors: torch.Tensor) -> torch.device:
    devs = {t.device for t in tensors.values()}
    dev = next(iter(devs))
    if len(devs) != 1 or dev.type != "cuda":
        raise ValueError(
            "the CUDA D-slash kernels take tensors on one CUDA device, got "
            + ", ".join(f"{k} on {t.device}" for k, t in tensors.items()))
    for k, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{k} must be 16-byte aligned")
    return dev


def _site_shape(psi_s: torch.Tensor) -> tuple:
    if psi_s.dim() != 7 or tuple(psi_s.shape[4:]) != (4, 3, 2):
        raise ValueError(f"psi_s must have shape (X, Y, Z, T, 4, 3, 2), got "
                         f"{tuple(psi_s.shape)}")
    return tuple(psi_s.shape[:4])


def _raise_on(err: int, kernel: str) -> None:
    if err:
        msg = _lib().dslash_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: {msg} (cudaError {err})")


def dslash_split(U_s: torch.Tensor, psi_s: torch.Tensor) -> torch.Tensor:
    """Full-lattice periodic D-slash on re/im-split fields.

    U_s: (4, X, Y, Z, T, 3, 3, 2) f32; psi_s: (X, Y, Z, T, 4, 3, 2) f32.
    """
    lat = _site_shape(psi_s)
    _check("psi_s", psi_s, lat + (4, 3, 2))
    _check("U_s", U_s, (4,) + lat + (3, 3, 2))
    dev = _check_cuda(U_s=U_s, psi_s=psi_s)
    out = torch.empty_like(psi_s)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(_lib().dslash_full_launch(
        U_s.data_ptr(), psi_s.data_ptr(), out.data_ptr(), *lat, dev.index,
        stream), "dslash_split")
    LAUNCHES["dslash_split"] += 1
    return out


def dslash_eo_split(U_out_s: torch.Tensor, U_src_s: torch.Tensor,
                    psi_s: torch.Tensor, src_parity: int) -> torch.Tensor:
    """Half-lattice D-slash hop on re/im-split compact fields.

    U_out_s/U_src_s: (4, X//2, Y, Z, T, 3, 3, 2) f32 packed at the
    output/source parity; psi_s: (X//2, Y, Z, T, 4, 3, 2) f32 on
    ``src_parity`` sites.  Returns the opposite-parity half-field.
    """
    if src_parity not in (0, 1):
        raise ValueError(f"src_parity must be 0 or 1, got {src_parity!r}")
    lat = _site_shape(psi_s)
    _check("psi_s", psi_s, lat + (4, 3, 2))
    _check("U_out_s", U_out_s, (4,) + lat + (3, 3, 2))
    _check("U_src_s", U_src_s, (4,) + lat + (3, 3, 2))
    dev = _check_cuda(U_out_s=U_out_s, U_src_s=U_src_s, psi_s=psi_s)
    out = torch.empty_like(psi_s)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(_lib().dslash_eo_launch(
        U_out_s.data_ptr(), U_src_s.data_ptr(), psi_s.data_ptr(),
        out.data_ptr(), *lat, 1 - src_parity, dev.index, stream),
        "dslash_eo_split")
    LAUNCHES["dslash_eo_split"] += 1
    return out
