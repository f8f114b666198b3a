"""ctypes wrappers of the hand-written CUDA D-slash kernels
(``csrc/dslash.cu``), on the re/im-split float32 layout of the JAX
package's Pallas kernels.

Each wrapper checks its inputs, allocates the output with ``torch.empty``,
launches on the current CUDA stream without synchronising, raises if the
launch was refused, and counts the launch in ``LAUNCHES``.  It takes CUDA
tensors only: the plain versions for the CPU are in ``ref.py``, and the
fused Schur operator's is the composition it replaces
(``repro_torch.lqcd.eo.schur_composed``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import library

# launches of each kernel in this process; a run that must show it went
# through the kernels sets these to 0 before and reads them after.
# "dslash_eo_split" counts every B1 hop, "dslash_eo_fused" those of them
# that the fused Schur operator (``schur_eo_split``) made
LAUNCHES = {"dslash_split": 0, "dslash_eo_split": 0, "dslash_eo_fused": 0}

# the inner types a fused Schur operator rounds through, by the kernel's
# code; f32, complex64 and f64 hold every f32 value, so they round nothing
_ROUND = {None: 0, torch.float32: 0, torch.complex64: 0, torch.float64: 0,
          torch.bfloat16: 1, torch.float16: 2}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("dslash")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dslash_full_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.dslash_full_launch.restype = i
    lib.dslash_eo_launch.argtypes = [p, p, p, p, i, i, i, i, i, p,
                                     ctypes.c_float, i, i, i, i, p]
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
    _eo_launch(U_out_s, U_src_s, psi_s, out, lat, 1 - src_parity, dev)
    return out


def _eo_launch(U_out_s, U_src_s, psi_s, out, lat, out_parity, dev,
               psi_epi=None, k2=0.0, rnd=0, g5=False, epi=False) -> None:
    """One B1 hop into ``out``: the plain hop, or with a load transform
    or an epilogue a hop of the fused Schur operator (``csrc/dslash.cu``)."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(_lib().dslash_eo_launch(
        U_out_s.data_ptr(), U_src_s.data_ptr(), psi_s.data_ptr(),
        out.data_ptr(), *lat, out_parity,
        None if psi_epi is None else psi_epi.data_ptr(), k2, rnd, int(g5),
        int(epi), dev.index, stream), "dslash_eo_split")
    LAUNCHES["dslash_eo_split"] += 1


def schur_eo_split(U_e_s: torch.Tensor, U_o_s: torch.Tensor,
                   psi_s: torch.Tensor, kappa: float, *, dagger: bool = False,
                   inner_dtype=None) -> torch.Tensor:
    """The even-odd Schur operator A = 1 - kappa^2 D_eo D_oe on re/im-split
    even half-fields, in two B1 launches.

    ``dagger`` False gives R(A R(psi)), True R(g5 A g5 psi) = R(A^+ psi),
    R the rounding of every real through ``inner_dtype`` (None, float32,
    complex64 and float64 round nothing): the two halves of the inner
    CG's normal operator, whose A^+ takes A's rounded output.  Bit for bit the
    composition of the plain hops, the roundings, gamma5 and the axpy
    ``psi - (kappa * kappa) * d`` it replaces.  U_e_s/U_o_s: (4, X//2, Y,
    Z, T, 3, 3, 2) f32 packed at the even/odd parity; psi_s: (X//2, Y, Z,
    T, 4, 3, 2) f32 on even sites.
    """
    if inner_dtype not in _ROUND:
        raise ValueError(f"inner_dtype must be one of {list(_ROUND)}, got "
                         f"{inner_dtype!r}")
    lat = _site_shape(psi_s)
    _check("psi_s", psi_s, lat + (4, 3, 2))
    _check("U_e_s", U_e_s, (4,) + lat + (3, 3, 2))
    _check("U_o_s", U_o_s, (4,) + lat + (3, 3, 2))
    dev = _check_cuda(U_e_s=U_e_s, U_o_s=U_o_s, psi_s=psi_s)
    fused = dict(k2=kappa * kappa, rnd=_ROUND[inner_dtype], g5=dagger)
    d = torch.empty_like(psi_s)
    out = torch.empty_like(psi_s)
    _eo_launch(U_o_s, U_e_s, psi_s, d, lat, 1, dev, **fused)   # even -> odd
    _eo_launch(U_e_s, U_o_s, d, out, lat, 0, dev, psi_epi=psi_s, epi=True,
               **fused)                                        # odd -> even
    LAUNCHES["dslash_eo_fused"] += 2
    return out
