"""RMSNorm on either device: the counterpart of the JAX package's
``repro.kernels.rmsnorm.ops.rmsnorm``.

A CPU tensor takes the plain version (``ref.py``), which autograd
differentiates directly; a CUDA tensor takes the hand-written kernel
(``kernel.py``), which raises on anything it cannot run.  There is no
fallback from the kernel to the plain version.  Where autograd records
the call, the kernel runs inside ``RMSNormFunction``, whose backward is
autograd of the plain version (``kernels/autograd.py``).

Tensors on the ``meta`` device (the dry run's trace) take the plain
version in the kernel's place, inside ``RMSNormFunction`` where autograd
records, so the trace allocates and saves what the card's call does; each
such call counts in ``kernel.TRACED``, not in ``kernel.LAUNCHES``.
Tensors on mixed devices go to the kernel, which raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.autograd import KernelFunction, needs_grad
from repro_torch.kernels.rmsnorm import kernel
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


class RMSNormFunction(KernelFunction):
    """B4 forward, autograd of ``rmsnorm_ref`` backward."""


def _kernel_nd(x: torch.Tensor, w: torch.Tensor,
               eps: float) -> torch.Tensor:
    shape = x.shape
    return kernel.rmsnorm(x.reshape(-1, shape[-1]), w, eps).reshape(shape)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """Fused RMSNorm over the last dim of x (..., d); w (d,).  Float32
    math, the result in ``x.dtype``.  Unlike the JAX wrapper, any row count
    works: the CUDA kernel has no block-divisibility condition."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    run = _kernel_nd
    if x.device.type == "meta" and w.device.type == "meta":
        kernel.TRACED["rmsnorm"] += 1
        run = rmsnorm_ref
    if needs_grad(x, w):
        return RMSNormFunction.apply(run, rmsnorm_ref, x, w, eps)
    return run(x, w, eps)
