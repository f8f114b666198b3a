"""The power engine: ``simulate(workload, operating_point) → PowerTrace``
(a copy of the JAX package's ``power/engine.py``).

Time-stepped simulation in the ExaDigiT/RAPS mold: a workload supplies a
relative load profile (synthetic shape or telemetry replay), the layered
cluster model converts load → per-component watts at each tick, and a
:class:`TraceRecorder` assembles the fixed-interval trace that the
Green500 methodology and the paper-table benchmarks consume.

The same module exposes ``evaluate_operating_point`` — node (perf,
power) at one knob setting — which is the query surface the autotuner's
cost model uses instead of carrying its own power model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, Tuple

import numpy as np

from repro_torch.power.layers import ClusterModel, NodeModel, lcsc_cluster
from repro_torch.power.model import (OperatingPoint, fan_curve,
                                     hpl_block_perf_scale,
                                     lookahead_perf_scale)
from repro_torch.power.trace import PowerTrace, TraceRecorder


def node_hpl_gflops(op: OperatingPoint, node: Optional[NodeModel] = None,
                    ) -> float:
    """Node Linpack GFLOPS at an operating point (throttle-aware perf
    model × blocking/lookahead calibration curves)."""
    from repro_torch.core.energy.throttle import hpl_node_perf
    node = node or NodeModel()
    return (hpl_node_perf(op.f_mhz, node.vids, temp_c=op.temperature(),
                          util=op.gpu_util())
            * hpl_block_perf_scale(op.nb) * lookahead_perf_scale(op.lookahead))


def evaluate_operating_point(op: OperatingPoint,
                             node: Optional[NodeModel] = None,
                             ) -> Tuple[float, float]:
    """(perf_gflops, wall_power_w) of one node at ``op`` — the engine
    query the autotuner's analytic cost model is built on."""
    node = node or NodeModel()
    perf = node_hpl_gflops(op, node)
    power = node.power(op)
    return perf, power


# ---------------------------------------------------------------------------
# Workloads: synthetic shapes and telemetry replay
# ---------------------------------------------------------------------------


class Workload(Protocol):
    """A relative GPU-load profile over time (both values in [0, 1])."""

    duration_s: float

    def load(self, t: float) -> float:
        ...


@dataclass(frozen=True)
class SyntheticHPL:
    """One HPL run: full load through factorization, N³-ish decay in the
    final quarter as the trailing matrix shrinks — the shape that makes
    Level-1 window-picking exploitable (paper §3).  Delegates to the
    single load-curve definition in :mod:`repro_torch.power.green500`."""

    duration_s: float = 3600.0
    tail_start: float = 0.75
    tail_floor: float = 0.35

    def load(self, t: float) -> float:
        from repro_torch.power.green500 import hpl_load_profile
        x = np.clip(t / self.duration_s, 0.0, 1.0)
        return float(hpl_load_profile(x, tail_start=self.tail_start,
                                      tail_floor=self.tail_floor))


@dataclass(frozen=True)
class ConstantLoad:
    """Steady-state operation (single-node calibration runs)."""

    duration_s: float = 600.0
    level: float = 1.0

    def load(self, t: float) -> float:
        return self.level


@dataclass(frozen=True)
class ReplayWorkload:
    """Replay a recorded utilization series (RAPS telemetry-replay mode):
    piecewise-linear interpolation of (t, util) samples."""

    t: np.ndarray
    util: np.ndarray

    @property
    def duration_s(self) -> float:
        return float(self.t[-1] - self.t[0])

    @classmethod
    def from_trace(cls, trace: PowerTrace,
                   key: str = "util") -> "ReplayWorkload":
        if key not in trace.aux:
            raise KeyError(f"trace has no {key!r} aux series "
                           f"(has {sorted(trace.aux)})")
        u = np.asarray(trace.aux[key], dtype=float)
        peak = float(np.max(u)) or 1.0
        return cls(np.asarray(trace.t, dtype=float), u / peak)

    def load(self, t: float) -> float:
        return float(np.interp(t, self.t, self.util))


# ---------------------------------------------------------------------------
# The simulation loop
# ---------------------------------------------------------------------------


def simulate(workload: Workload,
             op: Optional[OperatingPoint] = None, *,
             cluster: Optional[ClusterModel] = None,
             dt_s: float = 5.0,
             adaptive_fan: bool = True,
             recorder: Optional[TraceRecorder] = None) -> PowerTrace:
    """Run ``workload`` on ``cluster`` at ``op`` and return the telemetry.

    The workload's relative load is sampled on the tick grid, the fan
    duty derives from it (load-adaptive derating below the set point
    when ``adaptive_fan``, the paper's end-of-run fan curve), and the
    whole series is evaluated in one pass through the batched layer API
    (``ClusterModel.component_watts_series``) — per-sample results are
    identical to ticking the scalar layers.  FLOPS rate scales with
    load from the node perf model, so Green500 efficiency figures come
    straight off the returned :class:`PowerTrace`.
    """
    op = op or OperatingPoint.green500()
    cluster = cluster or lcsc_cluster()
    # explicit None check: an empty recorder is falsy (__len__ == 0) but
    # still the caller's bus
    rec = recorder if recorder is not None \
        else TraceRecorder(dt_s=dt_s, source="power.simulate")
    # a shared bus may carry earlier phases: stack after its latest
    # sample (the convention every emitter on the bus follows)
    t0 = rec.t_last
    cluster_gflops = float(sum(node_hpl_gflops(op, n)
                               for n in cluster.nodes))
    ts = np.arange(0.0, workload.duration_s + dt_s, dt_s)
    loads = np.clip([workload.load(min(float(t), workload.duration_s))
                     for t in ts], 0.0, 1.0)
    fans = np.minimum(op.fan, fan_curve(loads)) if adaptive_fan \
        else np.full(ts.shape, op.fan)
    watts = cluster.component_watts_series(op, load=loads, fan=fans)
    rec.emit_series(t0 + ts, watts, flops_rate=cluster_gflops * loads,
                    util=op.gpu_util() * loads, f_mhz=op.f_mhz,
                    fan=fans, temp_c=op.temperature())
    trace = rec.trace()
    trace.meta.setdefault("n_nodes", cluster.n_nodes)
    trace.meta.setdefault("operating_point", {
        "f_mhz": op.f_mhz, "vid": op.vid, "fan": op.fan, "nb": op.nb,
        "lookahead": op.lookahead})
    return trace
