"""Device-level power models — the calibration layer of
``repro_torch.power``, a copy of the JAX package's ``power/model.py``.

This module is the single definition point for every electrical
calibration constant of the port; the other modules import them.

Two devices are modelled:
  * the FirePro S9150 of the L-CSC cluster the paper measured, with the
    fan and HPL-blocking curves, exactly as the JAX package has them;
  * the port's own chip, an NVIDIA H100 SXM (``H100_SXM``): its rates are
    data-sheet constants (``repro_torch.roofline.hw``), its watts were
    measured on the card.  It replaces the JAX package's TPU chip model.

Calibration targets of the S9150 model (all published, paper Fig. 1 and
§2–4):
  * S9150 TDP 275 W; stock 900 MHz, efficiency clock 774 MHz
  * voltage IDs span 1.1425 V … 1.2 V at 900 MHz (Fig. 1a)
  * optimum fan duty 40%, power slope steeper above 40% (Fig. 1b)
  * Green500 run: 56 nodes, 57.2 kW → 1021 W/node at 774 MHz
  * node Linpack 6175–6280 GFLOPS @900 MHz, ≈5384 GFLOPS @774 MHz
    (301.5 TFLOPS / 56), efficiency 5271.8 MFLOPS/W

GPU model:  P_gpu = P_static(V, T) + K_DYN · f · V² · util   (f in GHz)
The node/rack/cluster composition (host, fans, PSU-efficiency curve,
network switches) lives in :mod:`repro_torch.power.layers`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from repro_torch.roofline import hw

# ---------------------------------------------------------------------------
# Device specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GPUSpec:
    name: str
    stream_processors: int
    fp64_flops_per_sp_per_cycle: float
    tdp_w: float
    mem_bw_gbs: float
    mem_gb: int

    def peak_fp64_gflops(self, f_ghz: float) -> float:
        return (self.stream_processors * self.fp64_flops_per_sp_per_cycle
                * f_ghz)


S9150 = GPUSpec("FirePro S9150", 2816, 1.0, 275.0, 320.0, 16)
S10000_CHIP = GPUSpec("FirePro S10000 (per chip)", 1792, 0.5, 187.5, 240.0, 6)

# Published clocks / voltages
STOCK_MHZ = 900
EFFICIENT_MHZ = 774
V_MIN = 1.1425           # best chips' voltage ID at 900 MHz
V_MAX = 1.2              # worst chips'

# Calibrated constants
P_GPU_STATIC_40C = 35.0  # W at 40 °C, V_MIN
TEMP_SLOPE_W_PER_C = 0.30
K_DYN = 200.0            # W / (GHz · V²): V_MIN chips just avoid throttle at 900
FAN_BASE_W = 12.0
FAN_CUBIC_W = 160.0      # node fans at 100% ≈ 172 W
V_F_SLOPE = 0.0006       # V per MHz of downclock


def voltage_at(f_mhz, vid_900):
    """Operating voltage at frequency f for a chip with voltage-ID vid_900.
    Array-aware over both axes: the per-bin batched layer entry points
    hand whole (clock, vid) spreads in at once."""
    v = np.maximum(0.8, vid_900 - V_F_SLOPE * (STOCK_MHZ
                                               - np.asarray(f_mhz)))
    return float(v) if np.ndim(v) == 0 else v


def gpu_static_power(vid_900, temp_c=55.0):
    """Static (leakage) draw at a voltage ID and temperature.  Array-aware
    over both axes (per-chip vid / per-sample temperature spreads)."""
    scale = (np.asarray(vid_900) / V_MIN) ** 2
    p = (P_GPU_STATIC_40C
         + TEMP_SLOPE_W_PER_C * np.maximum(np.asarray(temp_c) - 40.0, 0.0)) \
        * scale
    return float(p) if np.ndim(p) == 0 else p


def gpu_dynamic_power(f_ghz: float, v: float, util: float = 1.0) -> float:
    return K_DYN * f_ghz * v * v * util


def gpu_power(f_mhz: float, vid_900: float, *, temp_c: float = 55.0,
              util: float = 1.0, spec: GPUSpec = S9150) -> float:
    """Un-throttled electrical power draw (may exceed TDP — the throttle
    clamp reduces frequency, not physics; see ``gpu_power_throttled``)."""
    v = voltage_at(f_mhz, vid_900)
    return gpu_static_power(vid_900, temp_c) + gpu_dynamic_power(
        f_mhz / 1000.0, v, util)


def fan_power(speed):
    """Node fan power vs duty cycle in [0, 1] (cubic — Fig. 1b shape).
    Array-aware: an ndarray of duties returns an ndarray of watts."""
    s = np.clip(speed, 0.0, 1.0)
    p = FAN_BASE_W + FAN_CUBIC_W * s ** 3
    return float(p) if np.ndim(speed) == 0 else p


def sample_vids(rng: np.random.Generator, n: int) -> np.ndarray:
    """Manufacturing voltage-ID spread (paper: every ASIC differs)."""
    # triangular-ish spread within the published [V_MIN, V_MAX]
    return np.clip(rng.normal((V_MIN + V_MAX) / 2, 0.015, n), V_MIN, V_MAX)


# ---------------------------------------------------------------------------
# TDP throttle — the power side (paper §2, Fig. 1a)
# ---------------------------------------------------------------------------


def sustained_frequency(f_set_mhz: float, vid_900: float, *,
                        temp_c: float = 55.0, util: float = 1.0,
                        tdp_w: float = S9150.tdp_w) -> Tuple[float, bool]:
    """Highest clock the TDP allows; returns (f_sustained_MHz, throttled)."""
    v = voltage_at(f_set_mhz, vid_900)
    p_static = gpu_static_power(vid_900, temp_c)
    p_dyn = K_DYN * (f_set_mhz / 1000.0) * v * v * util
    if p_static + p_dyn <= tdp_w:
        return f_set_mhz, False
    # clamp: solve P_static + K f v(f)^2 util = TDP (v approximately fixed
    # at the set-point voltage — firmware lowers f, not V, under TDP)
    f = (tdp_w - p_static) / (K_DYN * v * v * util) * 1000.0
    return max(f, 100.0), True


def gpu_power_throttled(f_set_mhz: float, vid_900: float, *,
                        temp_c: float = 55.0, util=1.0,
                        tdp_w: float = S9150.tdp_w):
    """Actual draw: TDP when throttling, model power otherwise.
    Array-aware over ``util`` (the batched layer entry points hand a
    whole duty-cycle series in at once)."""
    v = voltage_at(f_set_mhz, vid_900)
    p = gpu_static_power(vid_900, temp_c) \
        + K_DYN * (f_set_mhz / 1000.0) * v * v * util
    if np.ndim(p) == 0:
        return min(float(p), tdp_w)
    return np.minimum(p, tdp_w)


# ---------------------------------------------------------------------------
# Calibration curves shared by the autotuner and the power engine
# (formerly private copies in ``autotune/measure.py``)
# ---------------------------------------------------------------------------

# Efficiency- vs performance-mode HPL update blocking (HPL-GPU's NB) and
# the Green500 run's sustained GPU duty cycle at efficiency NB.
NB_EFFICIENCY = 512
NB_PERFORMANCE = 1024
HPL_GPU_UTIL = 0.908


def temp_from_fan(fan: float, *, ambient_c: float = 40.0) -> float:
    """GPU steady-state temperature vs fan duty (calibrated: 55 °C @ 40%).

    The Fig. 1b trade is fan power (cubic in duty) vs the GPU
    static-power temperature slope; cooling degrades quadratically below
    the 40% optimum (airflow starves fast at low duty)."""
    return ambient_c + 2.4 / max(float(fan), 0.05) ** 2


def hpl_block_util(nb: float) -> float:
    """Sustained GPU duty cycle vs HPL update blocking.  Efficiency-mode
    NB (512) is the calibrated Green500-run value; bigger blocks keep the
    DGEMM pipeline fuller (and hotter)."""
    return float(np.clip(HPL_GPU_UTIL + 0.042 * np.log2(nb / NB_EFFICIENCY),
                         0.85, 0.95))


def hpl_block_perf_scale(nb: float) -> float:
    """Throughput vs blocking.  Saturating with a knee at the efficiency
    NB: going 512 → 1024 buys ~1.1% (GEMM amortization is nearly flat up
    there), while every halving below 512 costs quadratically (panel
    latency and pipeline drain stop amortizing)."""
    return float(max(1.0 - 0.015 * (NB_EFFICIENCY / nb) ** 2, 0.01))


def lookahead_perf_scale(depth: int) -> float:
    """Lookahead ≥ 1 fully overlaps panel factorization with the trailing
    update (HPL-GPU); depth 0 serializes it."""
    return 1.0 if depth >= 1 else 0.96


def fan_curve(load):
    """Load-adaptive fan duty (paper: 'a curve that defines different FAN
    duty cycles for different load levels', used at the end of the run).
    Array-aware: a load series returns a duty series."""
    duty = np.clip(0.15 + 0.25 * np.asarray(load) / 0.9, 0.15, 0.40)
    return float(duty) if np.ndim(load) == 0 else duty


# ---------------------------------------------------------------------------
# Operating point — the knob vector every layer of the engine accepts
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OperatingPoint:
    """One point in the paper's search space: clock, voltage ID, fan
    duty, HPL blocking and lookahead depth.

    ``temp_c``/``util`` default to the calibrated curves
    (``temp_from_fan`` / ``hpl_block_util``) and can be pinned
    explicitly, which is how the legacy ``node_power`` signature maps
    onto the engine."""

    f_mhz: float = float(EFFICIENT_MHZ)
    vid: float = V_MIN
    fan: float = 0.40
    # float: the autotuner maps CPU-scale HPL blocks onto a continuous
    # NB-equivalent axis (block · 2048 / n)
    nb: float = NB_EFFICIENCY
    lookahead: int = 1
    temp_c: Optional[float] = None
    util: Optional[float] = None

    @classmethod
    def green500(cls) -> "OperatingPoint":
        """The published record point: 774 MHz, VID floor, 40% fan,
        efficiency-mode blocking."""
        return cls()

    @classmethod
    def from_point(cls, point: Dict) -> "OperatingPoint":
        """Build from an autotuner point dict (``space.operating_space``)."""
        return cls(f_mhz=float(point["f_mhz"]), vid=float(point["vid"]),
                   fan=float(point["fan"]),
                   nb=float(point.get("nb", NB_EFFICIENCY)),
                   lookahead=int(point.get("lookahead", 1)))

    def temperature(self) -> float:
        return self.temp_c if self.temp_c is not None \
            else temp_from_fan(self.fan)

    def gpu_util(self) -> float:
        return self.util if self.util is not None \
            else hpl_block_util(self.nb)

    def replace(self, **kw) -> "OperatingPoint":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# PowerModel protocol — what every layer of the composition implements
# ---------------------------------------------------------------------------


@runtime_checkable
class PowerModel(Protocol):
    """Anything that can report component watts at an operating point.

    ``load`` scales the *dynamic* portion (GPU duty cycle) in [0, 1];
    ``fan`` overrides the operating point's duty (the engine's adaptive
    fan mode).  ``component_watts`` keys are stable component names
    (``gpu``, ``host``, ``fan``, ``psu_loss``, ``network``) whose values
    sum to ``power``."""

    def component_watts(self, op: OperatingPoint, *, load: float = 1.0,
                        fan: Optional[float] = None) -> Dict[str, float]:
        ...

    def power(self, op: OperatingPoint, *, load: float = 1.0,
              fan: Optional[float] = None) -> float:
        ...


# ---------------------------------------------------------------------------
# The port's chip: an NVIDIA H100 SXM (data sheet rates, measured watts)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ChipTable:
    """Power and rate constants of one accelerator.

    Board power at clock fraction ``f`` follows
    ``idle_w + dyn_compute_w · f² · compute_util + dyn_mem_w · mem_util``:
    the dynamic compute draw scales ~ f·V(f)² ≈ f², the HBM draw does not.
    The f² law is an assumption: the card's clocks cannot be set where its
    watts were measured, so it was not checked there.  The rates price the
    analytic roofline (``repro_torch.roofline.analytic``): bf16 peak, HBM,
    the chip-to-chip link and the link off the node."""

    name: str
    idle_w: float            # board watts, nothing running
    dyn_compute_w: float     # above idle, compute-bound at full clock
    dyn_mem_w: float         # above idle, HBM-bound
    power_limit_w: float     # the board's power limit
    peak_f32_flops: float
    peak_bf16_flops: float
    hbm_bw: float            # bytes/s
    link_bw: float = hw.NVLINK_BW   # bytes/s a chip sends to a peer
    dcn_bw: float = hw.DCN_BW       # bytes/s a chip sends off its node


# Measured on the card by ``chip_smoke.py`` phase [13]: the mean of
# ``nvidia-smi --query-gpu=power.draw`` sampled every 100 ms over 3 s with
# the card idle (a CUDA context open, SM clock 1980 MHz), over a loop of
# the thermal (32^3 x 8) Schur normal op A†A on the even-odd D-slash
# kernel (HBM-bound: 4 hops per op; 3652 ops/s, the card kept busy), and
# over a loop of HPL's step-0 trailing update at n = 32768 on the GEMM
# kernel (compute-bound: 12.7 ms against 2.5 ms of bytes).  That loop
# draws the power limit: the SM clock fell to 1950 MHz from 1980, so the
# compute-bound figure is capped by the limit.  A host that paces the A†A
# loop slower reads less (447.67 W at 3044 ops/s on another machine).
H100_MEASURED_ON = "NVIDIA H100 80GB HBM3, 700.00 W"   # nvidia-smi name, limit
H100_IDLE_W = 120.39
H100_MEM_BOUND_W = 517.34
H100_COMPUTE_BOUND_W = 698.25

H100_SXM = ChipTable(
    name="NVIDIA H100 SXM",
    idle_w=H100_IDLE_W,
    dyn_compute_w=H100_COMPUTE_BOUND_W - H100_IDLE_W,
    dyn_mem_w=H100_MEM_BOUND_W - H100_IDLE_W,
    power_limit_w=hw.POWER_LIMIT_W,          # data sheet
    peak_f32_flops=hw.PEAK_F32_FLOPS,        # data sheet
    peak_bf16_flops=hw.PEAK_BF16_FLOPS,      # data sheet
    hbm_bw=hw.HBM_BW,                        # data sheet
    link_bw=hw.NVLINK_BW,                    # data sheet
    dcn_bw=hw.DCN_BW)                        # DGX H100 data sheet


def h100_chip_power(freq_scale: float, compute_util: float,
                    mem_util: float, chip: ChipTable = H100_SXM) -> float:
    """P(f) for one chip: dynamic compute power scales ~ f·V(f)² ≈ f²."""
    f = float(np.clip(freq_scale, 0.3, 1.0))
    return (chip.idle_w + chip.dyn_compute_w * f * f * compute_util
            + chip.dyn_mem_w * mem_util)


@dataclass(frozen=True)
class H100ChipModel:
    """:class:`PowerModel` adapter for a :class:`ChipTable`, so the port's
    entry points (HPL, the LQCD calibration) can emit telemetry through
    the same engine as the GPU cluster."""

    freq_scale: float = 1.0
    compute_util: float = 1.0
    mem_util: float = 0.5
    chip: ChipTable = H100_SXM

    def component_watts(self, op: OperatingPoint = OperatingPoint(), *,
                        load: float = 1.0,
                        fan: Optional[float] = None) -> Dict[str, float]:
        dyn = h100_chip_power(self.freq_scale, self.compute_util * load,
                              self.mem_util * load, self.chip) \
            - self.chip.idle_w
        return {"chip_idle": self.chip.idle_w, "chip_dyn": dyn}

    def power(self, op: OperatingPoint = OperatingPoint(), *,
              load: float = 1.0, fan: Optional[float] = None) -> float:
        return float(sum(self.component_watts(op, load=load).values()))


# re-exported field helper so layers can build default populations
def uniform_vids(n: int, vid: float = V_MIN) -> Tuple[float, ...]:
    return tuple([vid] * n)


__all__ = [
    "GPUSpec", "S9150", "S10000_CHIP", "STOCK_MHZ", "EFFICIENT_MHZ",
    "V_MIN", "V_MAX", "P_GPU_STATIC_40C", "TEMP_SLOPE_W_PER_C", "K_DYN",
    "FAN_BASE_W", "FAN_CUBIC_W", "V_F_SLOPE", "voltage_at",
    "gpu_static_power", "gpu_dynamic_power", "gpu_power", "fan_power",
    "sample_vids", "sustained_frequency", "gpu_power_throttled",
    "NB_EFFICIENCY", "NB_PERFORMANCE", "HPL_GPU_UTIL", "temp_from_fan",
    "hpl_block_util", "hpl_block_perf_scale", "lookahead_perf_scale",
    "fan_curve", "OperatingPoint", "PowerModel", "ChipTable",
    "H100_MEASURED_ON", "H100_IDLE_W", "H100_MEM_BOUND_W",
    "H100_COMPUTE_BOUND_W", "H100_SXM", "h100_chip_power", "H100ChipModel",
    "uniform_vids",
]
