"""GEMM on either device: the counterpart of the JAX package's
``repro.kernels.dgemm.ops.dgemm``, and the in-place update that HPL's
trailing update runs.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor takes the
hand-written kernel (``kernel.py``), which raises on anything it cannot
run.  There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dgemm import kernel
from repro_torch.kernels.dgemm.ref import dgemm_ref, dgemm_update_ref_

DEFAULT_TILE = 256


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def dgemm(x: torch.Tensor, y: torch.Tensor, *, bm: int | None = None,
          bn: int | None = None, bk: int | None = None,
          tuned: bool = False) -> torch.Tensor:
    """``x @ y`` with a float32 accumulator, in ``x.dtype``.

    Tile resolution order, as in the JAX package: explicit ``bm/bn/bk``
    arguments, then (``tuned=True``) the autotune cache for this (m, k, n)
    and device (``repro_torch.autotune``; a miss runs the analytic tuner
    once and memoizes), then the static default of 256.  Each resolved
    tile, capped at its dimension, must divide that dimension, as
    ``matmul_pallas`` asserts, on either device.  On the card the kernel
    runs its 64-row tile when the resolved ``bm`` is below 128 and its
    128-row tile otherwise (``kernel.LAUNCHES`` counts each); ``bn`` and
    ``bk`` choose nothing there (both tiles are 128 wide with a k step of
    16), and neither tile changes the result.
    """
    (m, k), (k2, n) = x.shape, y.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}")
    if tuned and (bm is None or bn is None or bk is None):
        from repro_torch.autotune import tuned_config
        cfg = tuned_config("dgemm", (m, k, n), device=x.device)
        bm = cfg["bm"] if bm is None else bm
        bn = cfg["bn"] if bn is None else bn
        bk = cfg["bk"] if bk is None else bk
    tiles = [min(DEFAULT_TILE if t is None else t, d)
             for t, d in ((bm, m), (bn, n), (bk, k))]
    if any(d % t for t, d in zip(tiles, (m, n, k))):
        raise ValueError(f"dims ({m},{n},{k}) must tile by {tuple(tiles)}")
    if _on_cpu(x, y):
        return dgemm_ref(x, y)
    return kernel.dgemm(x, y, bm=kernel_rows(tiles[0]))


def kernel_rows(bm: int) -> int:
    """The rows of the kernel's tile that a resolved ``bm`` launches."""
    return 64 if bm < 128 else 128


def dgemm_update_(c: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """In place ``c -= x @ y`` (float32 accumulator); returns ``c``."""
    fn = dgemm_update_ref_ if _on_cpu(c, x, y) else kernel.dgemm_update_
    return fn(c, x, y)
