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
default).  The ``train`` and ``serve`` adapters are analytic: roofline
costs (``repro_torch.roofline.analytic``) and a DVFS plan, priced at
``chip`` (an H100 SXM by default, where the JAX package reads its TPU
constants).  ``serve_replay`` registers when ``repro_torch.serve.replay``
is imported, which ``make_workload`` does on first use.
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
from repro_torch.power.model import H100_SXM, STOCK_MHZ, ChipTable, \
    OperatingPoint
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


# kinds whose adapter lives outside this module and registers on import
_LAZY_KINDS = {"serve_replay": "repro_torch.serve.replay"}


def make_workload(kind: str, **kwargs) -> Workload:
    if kind not in WORKLOAD_REGISTRY and kind in _LAZY_KINDS:
        import importlib
        importlib.import_module(_LAZY_KINDS[kind])
    try:
        cls = WORKLOAD_REGISTRY[kind]
    except KeyError:
        raise KeyError(f"unknown workload kind {kind!r}; registered: "
                       f"{list_workloads()} (+lazy: {sorted(_LAZY_KINDS)})"
                       ) from None
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


def _plan_at(ac, mode: str, op: Optional[OperatingPoint],
             chip: ChipTable = H100_SXM):
    """DVFS plan for a roofline cost on ``chip``, with the clock grid
    capped at the operating point's frequency (relative to the stock
    clock) — how a scheduler-chosen derate (e.g. a power cap) reaches the
    chip-side frequency planner.  The train and serve adapters call it."""
    cfg = EnergyConfig(mode=mode)
    if op is not None:
        cap = op.f_mhz / STOCK_MHZ
        # below the grid's floor, run AT the cap (clamped to the chip
        # model's 0.3 validity floor) — never above it
        grid = tuple(f for f in cfg.freq_grid if f <= cap + 1e-9) \
            or (float(np.clip(cap, 0.3, 1.0)),)
        cfg = EnergyConfig(mode=mode, freq_grid=grid)
    return plan_frequency(ac.compute_s, ac.memory_s, ac.collective_s,
                          flops_per_step=ac.flops, cfg=cfg, chip=chip)


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


@register_workload("train")
@dataclass
class TrainWorkload:
    """The ``launch.train`` entry point's energy/telemetry path behind the
    Workload API: roofline step cost + DVFS plan + per-step chip-power
    emission, priced at ``chip``.  ``execute`` is analytic (no steps
    run), so schedulers can run it anywhere; the steps themselves run in
    :mod:`repro_torch.launch.train`, which prints this plan."""

    name: str = "train"
    arch: str = "olmo-1b"
    steps: int = 8
    batch: int = 8
    seq: int = 128
    smoke: bool = True
    remat: str = "none"            # must match the compiled step (the
                                   # launch.train entry uses remat="none")
    preferred_op: Optional[OperatingPoint] = None
    chip: ChipTable = H100_SXM
    _cost_cache: Optional[Any] = field(default=None, init=False,
                                       repr=False, compare=False)

    def _cost(self):
        if self._cost_cache is None:
            from repro_torch.config import (SINGLE_POD_MESH, ShapeConfig,
                                            TrainConfig, get_arch)
            from repro_torch.roofline.analytic import cost_for
            entry = get_arch(self.arch)
            cfg = entry.smoke() if self.smoke else entry.full()
            shape = ShapeConfig("custom", self.seq, self.batch, "train")
            self._cost_cache = cost_for(cfg, shape, SINGLE_POD_MESH,
                                        TrainConfig(remat=self.remat),
                                        chip=self.chip)
        return self._cost_cache

    def energy_plan(self, mode: str = "efficiency",
                    op: Optional[OperatingPoint] = None):
        """The DVFS plan for this step shape (shared with the launch entry
        point).  ``op`` caps the clock grid at the scheduler-chosen
        frequency."""
        ac = self._cost()
        return _plan_at(ac, mode, op, self.chip), ac

    def job(self) -> Job:
        ac = self._cost()
        # model + optimizer working set, with roofline bytes as the proxy
        mem_gb = max(ac.hbm_bytes / 1e9, 0.1)
        return Job(self.name, mem_gb,
                   work_units=self.steps * ac.flops / 1e12,
                   shardable=True, preferred_op=self.preferred_op,
                   kind=self.kind, state_bytes=self.state_bytes())

    def state_bytes(self) -> float:
        # params + optimizer moments (activations are recomputed on
        # restart) — the roofline HBM footprint is the honest upper bound
        return float(max(self._cost().hbm_bytes, 1e8))

    def execute(self, op: OperatingPoint, *,
                recorder: Optional[TraceRecorder] = None) -> WorkloadResult:
        plan, ac = self.energy_plan(op=op)
        rec = recorder if recorder is not None \
            else TraceRecorder(source="workload.train")
        t0 = rec.t_last
        step_s = plan.step_time_s
        for i in range(self.steps + 1):
            rec.emit(t0 + i * step_s, {"chip": plan.power_w},
                     flops_rate=0.0 if i == 0 else ac.flops / step_s / 1e9,
                     freq_scale=plan.freq_scale)
        trace = rec.trace()
        wall = self.steps * step_s
        return _result(self, op, trace, ac.flops / step_s / 1e9, wall,
                       window=(t0, t0 + wall),
                       steps=self.steps, dominant=plan.dominant,
                       freq_scale=plan.freq_scale)


@register_workload("serve")
@dataclass
class ServeWorkload:
    """The ``launch.serve`` entry point's energy/telemetry path behind the
    Workload API: prefill + decode roofline costs, decode-dominated DVFS
    plan, two-phase chip-power emission, priced at ``chip``."""

    name: str = "serve"
    arch: str = "llama3-8b"
    batch: int = 4
    prompt_len: int = 64
    gen: int = 32
    smoke: bool = True
    kv_int8: bool = False
    preferred_op: Optional[OperatingPoint] = None
    chip: ChipTable = H100_SXM
    _cost_cache: Optional[Any] = field(default=None, init=False,
                                       repr=False, compare=False)

    def _costs(self):
        if self._cost_cache is None:
            from repro_torch.config import (SINGLE_POD_MESH, ShapeConfig,
                                            get_arch)
            from repro_torch.roofline.analytic import cost_for
            entry = get_arch(self.arch)
            cfg = entry.smoke() if self.smoke else entry.full()
            total = self.prompt_len + self.gen
            dec = cost_for(cfg, ShapeConfig("serve", total, self.batch,
                                            "decode"),
                           SINGLE_POD_MESH, kv_int8=self.kv_int8,
                           chip=self.chip)
            pre = cost_for(cfg, ShapeConfig("serve_prefill", self.prompt_len,
                                            self.batch, "prefill"),
                           SINGLE_POD_MESH, kv_int8=self.kv_int8,
                           chip=self.chip)
            self._cost_cache = (pre, dec)
        return self._cost_cache

    def energy_plan(self, mode: str = "efficiency",
                    op: Optional[OperatingPoint] = None):
        """Decode-shape DVFS plan (shared with the launch entry point).
        ``op`` caps the clock grid at the scheduler-chosen frequency."""
        pre, dec = self._costs()
        return _plan_at(dec, mode, op, self.chip), pre, dec

    def job(self) -> Job:
        pre, dec = self._costs()
        mem_gb = max((pre.hbm_bytes + dec.hbm_bytes) / 1e9, 0.1)
        work = (pre.flops + self.gen * dec.flops) / 1e12
        return Job(self.name, mem_gb, work_units=work, shardable=True,
                   preferred_op=self.preferred_op, kind=self.kind,
                   state_bytes=self.state_bytes())

    def state_bytes(self) -> float:
        # serving is stateless (weights are re-loadable, the KV cache is
        # reconstructible): nothing to checkpoint, retries are the
        # resilience story (repro_torch.serve.autoscale RetryPolicy)
        return 0.0

    def execute(self, op: OperatingPoint, *,
                recorder: Optional[TraceRecorder] = None) -> WorkloadResult:
        plan, pre, dec = self.energy_plan(op=op)
        rec = recorder if recorder is not None \
            else TraceRecorder(source="workload.serve")
        t0 = rec.t_last
        t_pre = max(pre.compute_s, pre.memory_s) + pre.collective_s
        t_dec = self.gen * plan.step_time_s
        rec.emit(t0, {"chip": plan.power_w}, flops_rate=0.0,
                 freq_scale=plan.freq_scale)
        rec.emit(t0 + t_pre, {"chip": plan.power_w},
                 flops_rate=pre.flops / max(t_pre, 1e-12) / 1e9,
                 freq_scale=plan.freq_scale)
        rec.emit(t0 + t_pre + t_dec, {"chip": plan.power_w},
                 flops_rate=dec.flops / plan.step_time_s / 1e9,
                 freq_scale=plan.freq_scale)
        trace = rec.trace()
        wall = t_pre + t_dec
        perf = (pre.flops + self.gen * dec.flops) / wall / 1e9
        return _result(self, op, trace, perf, wall,
                       window=(t0, t0 + wall), gen=self.gen,
                       batch=self.batch, dominant=plan.dominant)


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
