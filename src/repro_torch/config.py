"""Solver configuration of the PyTorch/CUDA port.

A copy of the JAX package's ``SolverConfig``: the port keeps its own so
that it imports nothing of the reference package.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SolverConfig:
    """Dirac-inversion solver knobs (the paper's C1 workload: CL2QCD's
    even-odd preconditioned, mixed-precision CG).

    ``inner_dtype`` is the storage/traffic precision of the inner
    (defect-correction) CG; ``"none"`` disables mixed precision and runs
    the whole solve at working precision.  Dtypes are strings so the
    configuration does not depend on a framework.
    """

    preconditioner: str = "even_odd"   # none | even_odd
    inner_dtype: str = "bfloat16"      # none | bfloat16 | float16 | float32
    tol: float = 1e-6
    max_iters: int = 1000
    inner_tol: float = 1e-2            # reliable-update restart threshold
    max_outer: int = 30

    _INNER_DTYPES = ("none", "", "float32", "bfloat16", "float16", "float64")

    def __post_init__(self):
        if self.preconditioner not in ("none", "even_odd"):
            raise ValueError(f"unknown preconditioner {self.preconditioner!r}")
        if self.inner_dtype not in self._INNER_DTYPES:
            raise ValueError(f"unknown inner_dtype {self.inner_dtype!r}; "
                             f"one of {self._INNER_DTYPES}")

    @property
    def mixed_precision(self) -> bool:
        return self.inner_dtype not in ("none", "", "float32")
