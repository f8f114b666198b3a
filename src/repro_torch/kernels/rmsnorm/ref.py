"""Plain PyTorch version of the RMSNorm kernel: the oracle on the card and
the path the CPU takes.  A copy of the JAX package's ``_rmsnorm_kernel``
(``src/repro/kernels/rmsnorm/kernel.py:16``): float32 math, the output in
``x.dtype`` (a float64 input keeps float64 math, so that
``torch.autograd.gradcheck`` can run it)."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x**2, -1) + eps) * w`` over the last dim."""
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(acc)).to(x.dtype)
