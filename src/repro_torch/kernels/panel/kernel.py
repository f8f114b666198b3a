"""ctypes wrappers of the hand-written CUDA panel factorization and row
swaps of HPL's blocked LU (``csrc/panel.cu``).  The JAX package has no
Pallas kernel here: its panel is jnp code, and the plain versions the CPU
takes are ``repro_torch.hpl.lu._panel_factor`` and ``_swap_rest``.

Both wrappers take a row-major float32 matrix whose last stride is 1 (the
row stride may exceed the width) and the panel's ``nb`` pivots, int32 on
the same card, as rows of the matrix.  Each checks its inputs before it
loads the library, launches on the current CUDA stream without
synchronising, raises if the launch was refused, and counts the launch in
``LAUNCHES``.  They take CUDA tensors only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import library

# launches of each kernel in this process; a run that must show it went
# through the kernels sets these to 0 before and reads them after
LAUNCHES = {"panel_lu": 0, "laswp": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = library("panel")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.panel_lu_workspace.argtypes = [i, i]
    lib.panel_lu_workspace.restype = i64
    lib.panel_lu_launch.argtypes = [p, i64, i, i, i, p, p, i64, i, p]
    lib.panel_lu_launch.restype = i
    lib.laswp_launch.argtypes = [p, i64, i, i, i, p, i, p]
    lib.laswp_launch.restype = i
    lib.panel_error_string.argtypes = [i]
    lib.panel_error_string.restype = ctypes.c_char_p
    return lib


def _check(a: torch.Tensor, k0: int, nb: int,
           piv: torch.Tensor) -> torch.device:
    if a.dim() != 2 or a.dtype != torch.float32:
        raise TypeError(f"a must be a 2-D float32 matrix, got {a.dtype} of "
                        f"shape {tuple(a.shape)}")
    if a.stride(1) != 1 or a.stride(0) < a.shape[1]:
        raise ValueError(f"a must be row-major with unit column stride, got "
                         f"strides {a.stride()}")
    if piv.dtype != torch.int32 or tuple(piv.shape) != (nb,) or (
            nb > 1 and piv.stride(0) != 1):
        raise ValueError(f"piv must be {nb} contiguous int32, got "
                         f"{piv.dtype} of shape {tuple(piv.shape)}")
    rows, cols = a.shape
    if nb < 1 or k0 < 0 or k0 + nb > cols or rows - k0 < nb:
        raise ValueError(f"no {nb}-column panel at row and column {k0} of a "
                         f"{rows} x {cols} matrix")
    if a.device.type != "cuda" or piv.device != a.device:
        raise ValueError(f"the panel kernels take tensors on one CUDA device, "
                         f"got a on {a.device}, piv on {piv.device}")
    return a.device


def _raise_on(err: int, what: str) -> None:
    if err:
        msg = _lib().panel_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")


def panel_lu_(a: torch.Tensor, k0: int, nb: int,
              piv: torch.Tensor) -> None:
    """Factor the panel ``a[k0:, k0:k0 + nb]`` in place, with partial
    pivoting over the rows at and below each column and the row swaps
    within the panel's columns; write the pivot rows (rows of ``a``) to
    ``piv``.  The other columns are not touched (``laswp_``)."""
    dev = _check(a, k0, nb, piv)
    lib = _lib()
    work = torch.empty(lib.panel_lu_workspace(nb, dev.index),
                       dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    panel = a.data_ptr() + (k0 * a.stride(0) + k0) * a.element_size()
    _raise_on(lib.panel_lu_launch(
        panel, a.stride(0), a.shape[0] - k0, nb, k0, piv.data_ptr(),
        work.data_ptr(), work.numel(), dev.index, stream), "panel_lu")
    LAUNCHES["panel_lu"] += 1


def laswp_(a: torch.Tensor, k0: int, nb: int, piv: torch.Tensor) -> None:
    """Apply the swaps of rows ``k0 + j`` and ``piv[j]``, j < nb, in order,
    to the columns of ``a`` outside ``[k0, k0 + nb)``."""
    dev = _check(a, k0, nb, piv)
    if a.shape[1] == nb:
        return                      # nothing outside the panel: no launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(_lib().laswp_launch(
        a.data_ptr(), a.stride(0), a.shape[1], k0, nb, piv.data_ptr(),
        dev.index, stream), "laswp")
    LAUNCHES["laswp"] += 1
