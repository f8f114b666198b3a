"""Plain PyTorch versions of the GEMM kernel: the oracle on the card and
the path the CPU takes.  The contract of the JAX package's
``src/repro/kernels/dgemm/ref.py`` and ``matmul_pallas``: products summed
in float32, the result in the input dtype unless ``out_dtype`` says
otherwise."""
from __future__ import annotations

import torch


def dgemm_ref(x: torch.Tensor, y: torch.Tensor,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ y`` in float32, returned in ``out_dtype`` (default x.dtype)."""
    return (x.float() @ y.float()).to(out_dtype or x.dtype)


def dgemm_update_ref_(c: torch.Tensor, x: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """In place ``c -= x @ y``: the product in float32, subtracted in
    float32 and rounded once to ``c.dtype``.  Returns ``c``."""
    return c.sub_(x.float() @ y.float())
