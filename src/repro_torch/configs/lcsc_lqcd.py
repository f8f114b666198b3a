"""The paper's own workload: LQCD on the L-CSC cluster.

The lattice and solver presets and the published cluster constants of the
JAX package's ``configs/lcsc_lqcd.py``, copied so the port stands alone.
The constants are the paper's own figures for L-CSC and its FirePro S9150
GPUs; the power engine, the scheduler and the analytic LQCD calibration
read them.
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


@dataclass(frozen=True)
class LCSCNode:
    """Published per-node constants (paper Table 1 + §1)."""

    name: str
    cpu_cores: int
    gpus: int
    system_memory_gb: int
    gpu_stream_processors: int
    gpu_memory_gb: int
    gpu_peak_bandwidth_gbs: float     # aggregate per node
    peak_fp64_gflops: float           # aggregate per node


LOEWE_CSC = LCSCNode("LOEWE-CSC", 24, 1, 64, 1600, 1, 153.6, 745.6)
SANAM = LCSCNode("Sanam", 32, 4, 128, 7168, 12, 960.0, 3661.0)
L_CSC = LCSCNode("L-CSC", 40, 4, 256, 11264, 64, 1280.0, 10618.0)

# Per-GPU constants (paper §1)
S9150_BW_GBS = 320.0
S9150_MEM_GB = 16
S9150_TDP_W = 275.0
S10000_BW_GBS_PER_CHIP = 240.0
S10000_MEM_GB_PER_CHIP = 6

# Published application numbers (paper §1, §4)
DSLASH_GFLOPS_PER_S9150 = 135.0       # CL2QCD D-slash per S9150
DSLASH_BW_FRACTION = 0.80             # ~80% of peak memory bandwidth
CLUSTER_DSLASH_TFLOPS = 89.5
CLUSTER_PEAK_PFLOPS = 1.7
MULTI_GPU_SLOWDOWN = 0.20             # ~20% when a lattice spans >1 GPU

# Green500 run (paper §3–4)
GREEN500_NODES = 56
GREEN500_LINPACK_TFLOPS = 301.5
GREEN500_AVG_POWER_KW = 57.2
GREEN500_EFFICIENCY_MFLOPS_W = 5271.8
GREEN500_SWITCH_POWER_W = 257.0
SINGLE_NODE_EFFICIENCIES_MFLOPS_W = (
    5154.1, 5260.1, 5248.4, 5245.5, 5125.1, 5301.2, 5169.3)
NODE_VARIABILITY = 0.012              # ±1.2%
LEVEL1_OVERESTIMATE = 0.30            # up to 30% (paper §3)

# DVFS (paper §2, Fig. 1)
STOCK_CLOCK_MHZ = 900
EFFICIENT_CLOCK_MHZ = 774
BEST_CONSTANT_CLOCK_MHZ = 820
VOLTAGE_MIN = 1.1425
VOLTAGE_MAX = 1.2
DGEMM_GFLOPS_BEST_900 = 1250.0        # lowest-voltage GPUs @900 MHz
DGEMM_GFLOPS_WORST_900 = (950.0, 1100.0)
HPL_NODE_GFLOPS_900 = (6175.0, 6280.0)
OPTIMAL_FAN_SPEED = 0.40
DSLASH_EFF_PERF_LOSS = 0.015          # <1.5% at efficiency clocks
