"""The unified Workload API of the port: a copy of the JAX package's
``cluster/workload.py`` over the port's entry points.

``linpack_run(cfg)``, ``solve_dirac(U, b, kappa, cfg)`` and the power
engine's synthetic load shapes each have their own surface.  A
:class:`Workload` normalizes them into

  * ``job()``      → a :class:`repro_torch.cluster.scheduler.Job` spec
                     (memory, work units, shardability, preferred
                     operating point) the scheduler can place, and
  * ``execute()``  → a :class:`WorkloadResult` (perf, energy-to-solution)
                     carrying the :class:`repro_torch.power.PowerTrace`
                     the run emitted into the telemetry bus.

Adapters register themselves in the port's own ``WORKLOAD_REGISTRY`` so
callers can build batches by name (``make_workload("hpl")``).  The HPL
and LQCD adapters run the port's code on ``device`` (the card by
default).  The JAX package's ``train``, ``serve`` and ``serve_replay``
adapters are not ported yet: ``make_workload`` raises for them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Protocol, Type,
                    runtime_checkable)

import numpy as np

from repro_torch.cluster.scheduler import Job
from repro_torch.config import EnergyConfig
from repro_torch.core.energy.dvfs import plan_frequency
from repro_torch.lqcd.su3 import random_field_and_source
from repro_torch.power.model import STOCK_MHZ, OperatingPoint
from repro_torch.power.trace import PowerTrace, TraceRecorder


@dataclass(frozen=True)
class WorkloadResult:
    """What every workload returns: performance, energy-to-solution and
    the telemetry it was integrated from."""

    name: str
    kind: str
    perf_gflops: float
    wall_s: float
    energy_j: float
    power_trace: PowerTrace = field(repr=False)
    job: Job
    details: Dict[str, Any] = field(default_factory=dict)

    @property
    def gflops_per_w(self) -> float:
        return self.perf_gflops * self.wall_s / max(self.energy_j, 1e-12)


@runtime_checkable
class Workload(Protocol):
    """Anything the cluster can schedule and run.

    ``job()`` is the placement spec; ``execute(op)`` runs the workload's
    real (smoke-scale) or analytic code path at the given operating
    point, emits telemetry into ``recorder`` (or a private bus), and
    returns a :class:`WorkloadResult`.

    ``state_bytes()`` is the resilience surface: how many bytes a
    checkpoint of this workload streams to storage (the JAX package's
    ``CheckpointPolicy`` prices the Daly interval from it).  ``0.0``
    means *stateless* — nothing worth checkpointing (e.g. serving, whose
    KV cache is reconstructible) — and disables checkpoint scheduling for
    the job entirely."""

    name: str

    def job(self) -> Job:
        ...

    def state_bytes(self) -> float:
        ...

    def execute(self, op: OperatingPoint, *,
                recorder: Optional[TraceRecorder] = None) -> WorkloadResult:
        ...


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

WORKLOAD_REGISTRY: Dict[str, Type] = {}


def register_workload(kind: str) -> Callable[[Type], Type]:
    def deco(cls: Type) -> Type:
        if kind in WORKLOAD_REGISTRY:
            raise ValueError(f"workload kind {kind!r} already registered")
        WORKLOAD_REGISTRY[kind] = cls
        cls.kind = kind
        return cls
    return deco


def list_workloads() -> List[str]:
    return sorted(WORKLOAD_REGISTRY)


# the JAX package's kinds the port does not run yet, and where they wait
_UNPORTED_KINDS = {
    "train": "ROADMAP A6 (the train step) and A7 (roofline.analytic)",
    "serve": "ROADMAP A6 (the attention families) and A7 "
             "(roofline.analytic)",
    "serve_replay": "ROADMAP A6 and A7 (serve/*)",
}


def make_workload(kind: str, **kwargs) -> Workload:
    if kind in _UNPORTED_KINDS:
        raise NotImplementedError(
            f"workload kind {kind!r} is not in the port yet: "
            f"{_UNPORTED_KINDS[kind]}")
    try:
        cls = WORKLOAD_REGISTRY[kind]
    except KeyError:
        raise KeyError(f"unknown workload kind {kind!r}; registered: "
                       f"{list_workloads()}") from None
    return cls(**kwargs)


def _result(wl, op: OperatingPoint, trace: PowerTrace, perf_gflops: float,
            wall_s: float, window: Optional[tuple] = None,
            **details) -> WorkloadResult:
    """``window`` bounds the energy integral to this workload's own
    emission span — on a shared bus the trace carries earlier phases
    too, and those must not be billed to this result."""
    energy = trace.energy_j() if window is None \
        else trace.energy_j(t0=window[0], t1=window[1])
    return WorkloadResult(
        name=wl.name, kind=wl.kind, perf_gflops=perf_gflops, wall_s=wall_s,
        energy_j=energy, power_trace=trace, job=wl.job(),
        details={"op_f_mhz": op.f_mhz, **details})


def _plan_at(ac, mode: str, op: Optional[OperatingPoint]):
    """DVFS plan for a roofline cost, with the clock grid capped at the
    operating point's frequency (relative to the stock clock) — how a
    scheduler-chosen derate (e.g. a power cap) reaches the chip-side
    frequency planner.  No adapter of the port calls it yet: the JAX
    package's train and serve adapters do (ROADMAP A6/A7)."""
    cfg = EnergyConfig(mode=mode)
    if op is not None:
        cap = op.f_mhz / STOCK_MHZ
        # below the grid's floor, run AT the cap (clamped to the chip
        # model's 0.3 validity floor) — never above it
        grid = tuple(f for f in cfg.freq_grid if f <= cap + 1e-9) \
            or (float(np.clip(cap, 0.3, 1.0)),)
        cfg = EnergyConfig(mode=mode, freq_grid=grid)
    return plan_frequency(ac.compute_s, ac.memory_s, ac.collective_s,
                          flops_per_step=ac.flops, cfg=cfg)


# ---------------------------------------------------------------------------
# Adapters
# ---------------------------------------------------------------------------


@register_workload("hpl")
@dataclass
class HPLWorkload:
    """``repro_torch.hpl.linpack_run`` behind the Workload API.

    The LU actually runs, on ``device``; the Job spec describes the
    paper-scale footprint (HPL fills GPU memory and shards node-wide, so
    it asks for a whole node and prefers the mode's operating point)."""

    name: str = "hpl"
    cfg: Optional[Any] = None          # HPLConfig; default SMOKE_HPL
    mem_gb: float = 52.0               # paper-scale: ~13 GB on each of 4 GPUs
    work_units: float = 1800.0
    tuned: bool = False
    device: str = "cuda"

    def __post_init__(self):
        if self.cfg is None:
            from repro_torch.configs.hpl import SMOKE_HPL
            self.cfg = SMOKE_HPL

    def job(self) -> Job:
        op = OperatingPoint.green500() if self.cfg.mode == "efficiency" \
            else OperatingPoint(f_mhz=900.0)
        return Job(self.name, self.mem_gb, self.work_units,
                   shardable=True, preferred_op=op, kind=self.kind,
                   state_bytes=self.state_bytes())

    def state_bytes(self) -> float:
        # the in-place factored matrix IS the restart state
        return self.mem_gb * 1e9

    def execute(self, op: OperatingPoint, *,
                recorder: Optional[TraceRecorder] = None) -> WorkloadResult:
        from repro_torch.hpl.linpack import linpack_run
        mode = "efficiency" if op.f_mhz < 900.0 else "performance"
        res = linpack_run(self.cfg, energy=EnergyConfig(mode=mode),
                          tuned=self.tuned, recorder=recorder,
                          device=self.device)
        t_end = float(res.power_trace.t[-1])
        return _result(self, op, res.power_trace, res.gflops, res.wall_s,
                       window=(t_end - res.wall_s, t_end),
                       residual=res.residual, n=res.n, block=res.block,
                       passed=res.passed)


@register_workload("lqcd")
@dataclass
class LQCDSolveWorkload:
    """``repro_torch.lqcd.solve_dirac`` (plain / even-odd mixed CG) behind
    the Workload API — the paper's production workload: one lattice per
    GPU, sharded only when the lattice outgrows chip memory.

    The solve runs on ``device`` on a field drawn by
    :func:`repro_torch.lqcd.su3.random_field_and_source` (the port's
    generator, not the JAX package's random stream).
    ``calibration`` (an :class:`repro_torch.lqcd.LQCDCalibration`, e.g.
    from ``measured_lqcd_calibration()``) replaces the analytic S9150
    roofline with figures measured on the executed normal op: the energy
    model then streams at the calibration's effective bandwidth and burns
    its busy watts.  Left ``None``, the energy model is the analytic S9150
    path of the JAX adapter."""

    name: str = "lqcd"
    lattice: Optional[Any] = None      # LatticeConfig; default SMOKE_LATTICE
    seed: int = 0
    calibration: Optional[Any] = None  # LQCDCalibration; default analytic
    device: str = "cuda"

    def __post_init__(self):
        if self.lattice is None:
            from repro_torch.configs.lcsc_lqcd import SMOKE_LATTICE
            self.lattice = SMOKE_LATTICE

    def job(self) -> Job:
        # thermal lattices run one-per-GPU; work scales with volume
        return Job(self.name, self.lattice.mem_gb,
                   work_units=self.lattice.volume / 4096.0,
                   shardable=True, preferred_op=OperatingPoint.green500(),
                   kind=self.kind, state_bytes=self.state_bytes())

    def state_bytes(self) -> float:
        # gauge configuration + current solver iterate — the GPU-resident
        # lattice working set restarts the trajectory
        return self.lattice.mem_gb * 1e9

    def execute(self, op: OperatingPoint, *,
                recorder: Optional[TraceRecorder] = None) -> WorkloadResult:
        from repro_torch.core.energy.solver_energy import (SolverHW,
                                                           solver_energy)
        from repro_torch.lqcd import solve_dirac
        from repro_torch.power.model import gpu_power_throttled

        U, b = random_field_and_source(self.lattice.shape, self.seed,
                                       self.device)
        res = solve_dirac(U, b, self.lattice.kappa, self.lattice.solver)
        scfg = self.lattice.solver
        eo = scfg.preconditioner != "none"
        inner_bytes = 2 if (eo and scfg.mixed_precision) else 4
        cal = self.calibration
        if cal is not None:
            # measured figures (repro_torch.lqcd.multichip_eo): stream at
            # the executed effective bandwidth, burn the calibrated busy
            # watts
            hw = SolverHW(name=f"{cal.source}:{cal.n_devices}chip",
                          bandwidth_gbs=cal.eff_bw_gbs, bw_fraction=1.0,
                          power_w=cal.busy_w)
        else:
            # the operating point sets device power (undervolted/derated
            # chips draw less); the memory-bound solve time barely moves
            # with clock — the paper's <1.5% claim — so bandwidth stays at
            # the S9150 spec
            hw = SolverHW(power_w=gpu_power_throttled(
                op.f_mhz, op.vid, temp_c=op.temperature(), util=1.0))
        rep = solver_energy(
            f"cg/{self.name}", self.lattice.volume, int(res.iters),
            outer_ops=int(getattr(res, "outer_iters", 0)),
            inner_real_bytes=inner_bytes, even_odd=eo, hw=hw,
            recorder=recorder)
        t_end = float(rep.trace.t[-1])
        extra = {}
        if cal is not None:
            from repro_torch.lqcd.multichip_eo import (
                analytic_lqcd_calibration)
            ana = analytic_lqcd_calibration(cal.lattice, cal.n_devices)
            extra = dict(calibration_source=cal.source,
                         cal_n_devices=cal.n_devices,
                         cal_gflops=cal.gflops,
                         cal_gflops_per_w=cal.gflops_per_w,
                         cal_vs_analytic=cal.gflops / max(ana.gflops, 1e-9))
        return _result(self, op, rep.trace, rep.gflops, rep.time_s,
                       window=(t_end - rep.time_s, t_end),
                       iters=int(res.iters),
                       outer_iters=int(getattr(res, "outer_iters", 0)),
                       rel_residual=float(res.rel_residual),
                       converged=bool(res.converged), **extra)


@register_workload("synthetic")
@dataclass
class SyntheticWorkload:
    """``repro_torch.power.simulate``'s synthetic load shapes behind the
    Workload API: a relative load profile driven through the layered
    cluster model (single node by default)."""

    name: str = "synthetic"
    profile: Optional[Any] = None      # engine load profile (SyntheticHPL…)
    n_nodes: int = 1
    mem_gb: float = 13.0
    work_units: float = 600.0
    preferred_op: Optional[OperatingPoint] = None

    def __post_init__(self):
        if self.profile is None:
            from repro_torch.power.engine import ConstantLoad
            self.profile = ConstantLoad(duration_s=600.0)

    def job(self) -> Job:
        return Job(self.name, self.mem_gb, self.work_units,
                   shardable=True, preferred_op=self.preferred_op,
                   kind=self.kind, state_bytes=self.state_bytes())

    def state_bytes(self) -> float:
        return self.mem_gb * 1e9

    def execute(self, op: OperatingPoint, *,
                recorder: Optional[TraceRecorder] = None) -> WorkloadResult:
        from repro_torch.power.engine import simulate
        from repro_torch.power.layers import lcsc_cluster
        cluster = lcsc_cluster(self.n_nodes,
                               nodes_per_rack=min(self.n_nodes, 8))
        t0 = recorder.t_last if recorder is not None else 0.0
        trace = simulate(self.profile, op, cluster=cluster,
                         recorder=recorder)
        wall = float(self.profile.duration_s)
        # sustained GFLOPS over this profile's own window (a shared bus
        # carries other phases' flops too)
        perf = trace.total_flops(t0, t0 + wall) / max(wall, 1e-12)
        return _result(self, op, trace, perf, wall,
                       window=(t0, t0 + wall),
                       n_nodes=self.n_nodes,
                       profile=type(self.profile).__name__)
