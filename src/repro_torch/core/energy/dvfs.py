"""Roofline-coupled DVFS planning — the paper's C5 as framework machinery
(a copy of the JAX package's ``core/energy/dvfs.py``; the chip enters
``plan_frequency`` as a table, an NVIDIA H100 SXM by default).

The paper's insight, generalized: a step's time is max(compute, memory,
collective); only the compute term scales with clock.  For memory-/
collective-bound phases (the paper's D̸; our decode cells) the clock can be
dropped with near-zero perf loss (<1.5% in the paper).  For compute-bound
phases the best clock is the highest NON-THROTTLING one (774-vs-900 MHz).

``plan_frequency`` makes that decision from the roofline terms of a compiled
step; ``heuristic_search`` reproduces the paper's parameter-space search
(frequency x fan) on the calibrated node model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Sequence, Tuple

from repro_torch.config import EnergyConfig
from repro_torch.core.energy.throttle import h100_sustained_scale
from repro_torch.power.model import (H100_SXM, ChipTable,  # noqa: F401
                                     fan_curve, h100_chip_power)
# (fan_curve is re-exported here, as the JAX package's module does)


@dataclass(frozen=True)
class FreqPlan:
    freq_scale: float            # chosen clock (fraction of peak)
    step_time_s: float
    power_w: float               # per chip
    energy_per_step_j: float
    perf_loss: float             # vs best achievable step time
    throttled: bool
    efficiency_flops_per_w: float
    dominant: str


def _step_time(freq: float, compute_s: float, memory_s: float,
               collective_s: float) -> float:
    return max(compute_s / max(freq, 1e-6), memory_s, collective_s)


def plan_frequency(compute_s: float, memory_s: float, collective_s: float,
                   *, flops_per_step: float = 0.0,
                   cfg: EnergyConfig = EnergyConfig(),
                   chip_eff: float = 1.0,
                   chip: ChipTable = H100_SXM) -> FreqPlan:
    """Pick the per-step clock from the roofline decomposition.  ``chip``
    supplies the watts and the power limit (the JAX function reads its
    TPU constants instead)."""
    total = max(compute_s + memory_s + collective_s, 1e-12)

    def evaluate(f: float) -> FreqPlan:
        cu = compute_s / total
        mu = memory_s / total
        f_sus, throttled = h100_sustained_scale(f, cu, mu, chip_eff=chip_eff,
                                                chip=chip)
        t = _step_time(f_sus, compute_s, memory_s, collective_s)
        if throttled:
            t *= 1.05                         # oscillation penalty
        p = h100_chip_power(f_sus, cu * (compute_s / max(f_sus, 1e-6)) / t,
                            mu * memory_s / t, chip)
        e = p * t
        eff = flops_per_step / e if e > 0 else 0.0
        return FreqPlan(f, t, p, e, 0.0, throttled, eff,
                        dominant=max((("compute", compute_s),
                                      ("memory", memory_s),
                                      ("collective", collective_s)),
                                     key=lambda kv: kv[1])[0])

    plans = [evaluate(f) for f in cfg.freq_grid]
    best_t = min(p.step_time_s for p in plans)
    plans = [FreqPlan(p.freq_scale, p.step_time_s, p.power_w,
                      p.energy_per_step_j,
                      p.step_time_s / best_t - 1.0, p.throttled,
                      p.efficiency_flops_per_w, p.dominant) for p in plans]
    if cfg.mode == "performance":
        # highest clock that does not throttle (the 774-vs-900 result);
        # fall back to min step time
        ok = [p for p in plans if not p.throttled]
        pool = ok or plans
        return min(pool, key=lambda p: (p.step_time_s, p.power_w))
    # efficiency mode: min energy subject to bounded perf loss
    ok = [p for p in plans if p.perf_loss <= cfg.max_perf_loss]
    pool = ok or plans
    return min(pool, key=lambda p: p.energy_per_step_j)


# ---------------------------------------------------------------------------
# The paper's heuristic parameter search (node model, GPU cluster)
# ---------------------------------------------------------------------------


def heuristic_search(objective: Callable[[float, float], Tuple[float, float]],
                     freqs_mhz: Sequence[float],
                     fans: Sequence[float]) -> Dict:
    """Grid search over (frequency, fan duty) maximizing perf/power.

    ``objective(f_mhz, fan)`` returns (perf_gflops, power_w).  Mirrors the
    paper's 'heuristic search in the parameter space of GPU voltage, GPU and
    CPU frequencies, fan speed settings'."""
    best = None
    trace = []
    for f in freqs_mhz:
        for s in fans:
            perf, power = objective(f, s)
            eff = perf / max(power, 1e-9)
            trace.append({"f_mhz": f, "fan": s, "perf_gflops": perf,
                          "power_w": power, "mflops_per_w": eff * 1000.0})
            if best is None or eff > best["mflops_per_w"] / 1000.0:
                best = trace[-1]
    return {"best": best, "trace": trace}
