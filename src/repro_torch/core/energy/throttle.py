"""TDP throttle *performance* curves (paper §2, Fig. 1a); a copy of the
JAX package's ``core/energy/throttle.py`` whose TPU throttle is replaced
by the port's chip table (``h100_sustained_scale``).

The electrical side of throttling (``sustained_frequency``,
``gpu_power_throttled``) lives in :mod:`repro_torch.power.model` with the
rest of the calibration constants; this module keeps the performance
story built on top of it and re-exports the power-side names.

The paper's key observations, reproduced by this model:
  * chips with higher voltage ID hit the TDP limit and throttle; the
    throttled clock oscillates, which is LESS efficient than constant
    operation at the highest non-throttling frequency;
  * at 774 MHz no chip throttles → flat performance profile across nodes;
  * at 900 MHz DGEMM spans 1250 (V=1.1425) down to 950–1100 (V=1.2).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from repro_torch.power.model import (  # noqa: F401  (re-exported)
    H100_SXM,
    HPL_GPU_UTIL,
    S9150,
    ChipTable,
    gpu_power_throttled,
    sustained_frequency,
)

# Oscillating between P-states loses pipeline efficiency vs constant clock
OSC_PENALTY = 0.08
DGEMM_EFF = 0.493           # CL2QCD-era DGEMM efficiency vs fp64 peak
# HPL-GPU pipelines CPU DGEMM + lookahead: node HPL exceeds 4x standalone
# DGEMM (published: 6175-6280 node vs 4x950-1250 standalone).  The scale
# bundles the CPU DGEMM share and lookahead overlap; HPL's burstier GPU
# duty cycle (util < 1) throttles less than the continuous DGEMM loop.
HPL_NODE_SCALE = 1.256


def effective_frequency(f_set_mhz: float, vid_900: float, *,
                        temp_c: float = 55.0, util: float = 1.0) -> float:
    """Average effective clock including the oscillation penalty."""
    f_sus, throttled = sustained_frequency(f_set_mhz, vid_900,
                                           temp_c=temp_c, util=util)
    return f_sus * (1.0 - OSC_PENALTY) if throttled else f_sus


def dgemm_perf_gflops(f_set_mhz: float, vid_900: float, *,
                      temp_c: float = 55.0) -> float:
    """Single-GPU sustained DGEMM (fp64) — reproduces Fig. 1a left."""
    f_eff = effective_frequency(f_set_mhz, vid_900, temp_c=temp_c)
    return S9150.peak_fp64_gflops(f_eff / 1000.0) * DGEMM_EFF


def hpl_node_perf(f_set_mhz: float, vids: Sequence[float], *,
                  temp_c: float = 55.0,
                  util: float = HPL_GPU_UTIL) -> float:
    """Node HPL GFLOPS.  Multi-node HPL is gated by the slowest node, so
    cluster perf = n_nodes * min(node perf) (paper §2).

    ``util`` is the sustained GPU duty cycle (blocking-dependent — the
    autotuner's analytic model varies it with HPL's NB; the default is
    the calibrated Green500-run value).

    No oscillation penalty: HPL's phase structure (panel factorization /
    update bursts) absorbs the P-state dithering that hurts the
    continuous DGEMM loop."""
    gpu = 0.0
    for v in vids:
        f_sus, _ = sustained_frequency(f_set_mhz, v, temp_c=temp_c,
                                       util=util)
        gpu += S9150.peak_fp64_gflops(f_sus / 1000.0) * DGEMM_EFF
    return gpu * HPL_NODE_SCALE


def cluster_hpl_perf(f_set_mhz: float, node_vids: Sequence[Sequence[float]],
                     *, temp_c: float = 55.0) -> float:
    """Slowest node dictates (synchronous distribution of HPL panels)."""
    per_node = [hpl_node_perf(f_set_mhz, vids, temp_c=temp_c)
                for vids in node_vids]
    return len(per_node) * min(per_node)


# ---------------------------------------------------------------------------
# The port's chip (an NVIDIA H100 SXM by default)
# ---------------------------------------------------------------------------

def h100_sustained_scale(freq_scale: float, compute_util: float,
                         mem_util: float, *, chip_eff: float = 1.0,
                         chip: ChipTable = H100_SXM) -> Tuple[float, bool]:
    """Clock fraction the chip sustains under its power limit; chip_eff < 1
    models a worse-binned chip (higher draw).

    Returns (sustained freq scale, throttled)."""
    p = (chip.idle_w + chip.dyn_compute_w * freq_scale ** 2 * compute_util
         / chip_eff + chip.dyn_mem_w * mem_util)
    if p <= chip.power_limit_w:
        return freq_scale, False
    f2 = (chip.power_limit_w - chip.idle_w - chip.dyn_mem_w * mem_util) \
        * chip_eff / max(chip.dyn_compute_w * compute_util, 1e-9)
    return float(np.sqrt(max(f2, 0.09))), True
