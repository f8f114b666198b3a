"""Energy-to-solution model for the CG/D-slash workload (paper §1, §4); a
copy of the JAX package's ``core/energy/solver_energy.py`` plus
``H100_HW``, the port's chip in the same shape.

The paper's efficiency story is solver-level: D-slash is memory-bound, so
time-to-solution is (bytes moved) / (effective bandwidth), and
energy-to-solution is that time times device power.  Even-odd
preconditioning and reduced precision both enter through the byte count:

  * one normal-op application (M†M, or the Schur A†A) streams two
    D-slash-equivalents of traffic regardless of preconditioning — the
    even-odd win per op is in the *CG vector algebra*, whose vectors are
    half as long — and preconditioning cuts the number of ops;
  * reduced inner precision scales every byte of the inner iterations.

``solver_energy`` turns measured iteration counts into the paper-style
figure of merit (GFLOPS/W).  Device constants come from the power
engine (:mod:`repro_torch.power`) — the S9150 spec, the published
bandwidth fraction and the H100 table are referenced, not re-declared —
and each report carries the :class:`repro_torch.power.PowerTrace` its
energy was integrated from, so solver runs land on the same telemetry
bus as everything else.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs.lcsc_lqcd import DSLASH_BW_FRACTION
from repro_torch.lqcd.dirac import (dslash_bytes_per_site,
                                    dslash_flops_per_site)
from repro_torch.power.model import H100_SXM, S9150, h100_chip_power
from repro_torch.power.trace import PowerTrace, TraceRecorder

# CG linear algebra per normal-op iteration: x/r/p updates and the two
# reductions touch ~10 spinor-vector streams (24 reals per site each).
CG_VECTOR_STREAMS = 10
REALS_PER_SPINOR = 24


@dataclass(frozen=True)
class SolverHW:
    """Device constants for the bandwidth/power model (default: FirePro
    S9150, the paper's GPU — taken from the ``repro_torch.power`` spec)."""

    name: str = S9150.name
    bandwidth_gbs: float = S9150.mem_bw_gbs
    bw_fraction: float = DSLASH_BW_FRACTION    # CL2QCD reaches ~80% of peak
    power_w: float = S9150.tdp_w               # board TDP


S9150_HW = SolverHW()
# The port's chip: data-sheet HBM bandwidth at its full rate (the fraction
# a solve reaches is what ``measured_lqcd_calibration`` measures) and the
# table's HBM-bound watts, measured on the card.
H100_HW = SolverHW(name=H100_SXM.name, bandwidth_gbs=H100_SXM.hbm_bw / 1e9,
                   bw_fraction=1.0,
                   power_w=h100_chip_power(1.0, 0.0, 1.0, H100_SXM))


@dataclass(frozen=True)
class SolverEnergyReport:
    name: str
    normal_ops: int                    # total normal-op applications
    bytes_total: float
    time_s: float
    energy_j: float
    gflops: float                      # sustained, over the whole solve
    gflops_per_w: float
    trace: Optional[PowerTrace] = field(default=None, repr=False,
                                        compare=False)


def normal_op_bytes(volume: int, real_bytes: int, *, even_odd: bool,
                    compressed_links: bool = True) -> float:
    """Traffic of one normal-op application plus its CG vector algebra."""
    # M†M: two full-lattice hops; A†A: four half-lattice hops — same hop
    # traffic either way (2 x volume sites streamed per application)
    hop = 2 * volume * dslash_bytes_per_site(real_bytes, compressed_links)
    sites = volume // 2 if even_odd else volume
    vecs = CG_VECTOR_STREAMS * sites * REALS_PER_SPINOR * real_bytes
    return float(hop + vecs)


def solver_energy(name: str, volume: int, inner_ops: int, *,
                  outer_ops: int = 0, inner_real_bytes: int = 4,
                  outer_real_bytes: int = 4, even_odd: bool = False,
                  compressed_links: bool = True,
                  hw: SolverHW = S9150_HW,
                  recorder: Optional[TraceRecorder] = None,
                  ) -> SolverEnergyReport:
    """Energy-to-solution estimate from iteration counts.

    ``inner_ops`` are normal-op applications at ``inner_real_bytes``
    precision; ``outer_ops`` are full-precision defect-correction steps
    (residual recomputation ≈ one Schur application ≈ half a normal op,
    counted as a full one to stay conservative).

    The solve is emitted into a :class:`TraceRecorder` as a constant
    memory-bound device-power phase; energy is integrated from the
    resulting trace (``trace.energy_j()``), not from a private
    watts×seconds product.  A shared ``recorder`` may carry earlier
    phases — this solve is appended after its latest sample, so
    sequential solves stack on one bus instead of overlapping at t=0.
    """
    b = (inner_ops * normal_op_bytes(volume, inner_real_bytes,
                                     even_odd=even_odd,
                                     compressed_links=compressed_links)
         + outer_ops * normal_op_bytes(volume, outer_real_bytes,
                                       even_odd=even_odd,
                                       compressed_links=compressed_links))
    eff_bw = hw.bandwidth_gbs * 1e9 * hw.bw_fraction
    time_s = b / eff_bw
    flops = (inner_ops + outer_ops) * 2 * volume * dslash_flops_per_site()
    gflops = flops / time_s / 1e9

    # explicit None check (an empty recorder is falsy but still the
    # caller's bus); stack this phase after anything already recorded
    rec = recorder if recorder is not None \
        else TraceRecorder(source=f"solver:{name}")
    t0 = rec.t_last
    # memory-bound solve: flat device power over the run (two samples
    # bound the phase; recorder grids finer if dt_s is set)
    for t in (t0, t0 + time_s):
        rec.emit(t, {"gpu": hw.power_w}, flops_rate=gflops, util=1.0)
    trace = rec.trace()
    energy_j = trace.energy_j(t0=t0, t1=t0 + time_s)
    return SolverEnergyReport(name, inner_ops + outer_ops, b, time_s,
                              energy_j, gflops, gflops / hw.power_w,
                              trace=trace)
