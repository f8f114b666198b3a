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

    The tile arguments are accepted for parity with the JAX package: each
    (default 256, capped at its dimension) must divide its dimension, as
    ``matmul_pallas`` asserts, but they do not change the result, and the
    CUDA kernel uses its own 128 x 128 x 16 tile.  ``tuned=True`` raises
    until the autotuner's slice brings Hopper tile spaces.
    """
    if tuned:
        raise NotImplementedError(
            "tuned=True needs the autotuner, which the port does not have "
            "yet (ROADMAP A5: Hopper tile spaces)")
    (m, k), (k2, n) = x.shape, y.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: x {tuple(x.shape)}, "
                         f"y {tuple(y.shape)}")
    tiles = [min(DEFAULT_TILE if t is None else t, d)
             for t, d in ((bm, m), (bn, n), (bk, k))]
    if any(d % t for t, d in zip(tiles, (m, n, k))):
        raise ValueError(f"dims ({m},{n},{k}) must tile by {tuple(tiles)}")
    fn = dgemm_ref if _on_cpu(x, y) else kernel.dgemm
    return fn(x, y)


def dgemm_update_(c: torch.Tensor, x: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
    """In place ``c -= x @ y`` (float32 accumulator); returns ``c``."""
    fn = dgemm_update_ref_ if _on_cpu(c, x, y) else kernel.dgemm_update_
    return fn(c, x, y)
