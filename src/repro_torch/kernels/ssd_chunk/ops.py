"""One SSD chunk on either device: the counterpart of the JAX package's
``repro.kernels.ssd_chunk.ops.ssd_chunk``.

A CPU tensor takes the plain version (``ref.py``), which autograd
differentiates directly; a CUDA tensor takes the hand-written kernel
(``kernel.py``), which raises on anything it cannot run.  There is no
fallback from the kernel to the plain version.  Where autograd records
the call, the kernel runs inside ``SSDChunkFunction``, whose backward is
autograd of the plain version (``kernels/autograd.py``).

Tensors on the ``meta`` device (the dry run's trace) take the plain
version in the kernel's place, inside ``SSDChunkFunction`` where autograd
records, so the trace allocates and saves what the card's call does; each
such call counts in ``kernel.TRACED``, not in ``kernel.LAUNCHES``.
Tensors on mixed devices go to the kernel, which raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import KernelFunction, needs_grad
from repro_torch.kernels.ssd_chunk import kernel
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref


class SSDChunkFunction(KernelFunction):
    """B5 forward, autograd of ``ssd_chunk_ref`` backward."""


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B_mat: torch.Tensor, C_mat: torch.Tensor,
              h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk for all batches and heads.

    x: (B, Q, H, P); dt: (B, Q, H); A: (H,); B_mat/C_mat: (B, Q, N) (one
    group: the caller broadcasts); h: (B, H, P, N).  Returns
    (y (B, Q, H, P), h_new (B, H, P, N)), both float32.
    """
    args = (x, dt, A, B_mat, C_mat, h)
    if all(t.device.type == "cpu" for t in args):
        return ssd_chunk_ref(*args)
    run = kernel.ssd_chunk
    if all(t.device.type == "meta" for t in args):
        kernel.TRACED["ssd_chunk"] += 1
        run = ssd_chunk_ref
    if needs_grad(*args):
        return SSDChunkFunction.apply(run, ssd_chunk_ref, *args)
    return run(*args)
