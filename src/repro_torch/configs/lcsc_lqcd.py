"""The paper's own workload: LQCD on the L-CSC cluster.

The lattice and solver presets of the JAX package's
``configs/lcsc_lqcd.py``, copied so the port stands alone.
"""
from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.config import SolverConfig


@dataclass(frozen=True)
class LatticeConfig:
    """4D lattice for Wilson-Dirac D-slash."""

    shape: Tuple[int, int, int, int] = (32, 32, 32, 8)  # (x, y, z, t) thermal
    kappa: float = 0.137
    dtype: str = "float32"
    even_odd: bool = True
    solver: SolverConfig = field(default_factory=SolverConfig)

    @property
    def volume(self) -> int:
        v = 1
        for s in self.shape:
            v *= s
        return v

    @property
    def mem_gb(self) -> float:
        """Solver working-set estimate: gauge field (4 links × 18
        reals/site) plus ~16 spinor-field streams (x, r, p, Ap, even/odd
        halves, defect vectors) at 24 reals/site."""
        real_bytes = 4 if self.dtype == "float32" else 8
        reals_per_site = 4 * 18 + 16 * 24
        return self.volume * reals_per_site * real_bytes / 1e9


# Solver presets: plain full-lattice CGNE, and the paper's CL2QCD strategy
# (even-odd + reduced-precision inner CG).
PLAIN_SOLVER = SolverConfig(preconditioner="none", inner_dtype="none")
EO_SOLVER = SolverConfig(preconditioner="even_odd", inner_dtype="none")
EO_MIXED_SOLVER = SolverConfig(preconditioner="even_odd",
                               inner_dtype="bfloat16")

# A thermal (T > 0) lattice: time extent anti-proportional to temperature.
THERMAL_LATTICE = LatticeConfig(shape=(32, 32, 32, 8))
# A T ~ 0 lattice (needs much more memory — paper §1).
COLD_LATTICE = LatticeConfig(shape=(32, 32, 32, 64))
# Smoke lattice for CPU tests.
SMOKE_LATTICE = LatticeConfig(shape=(4, 4, 4, 4))
