"""The cluster run: ``run(jobs, policy) → ClusterRunResult`` (a copy
of the JAX package's ``cluster/run.py``).

Composition, not new physics: the scheduler places the batch on the
topology, the power layers report per-node component watts given which
chips are busy, and everything lands on one :class:`TraceRecorder` — so
the merged cluster-level :class:`repro_torch.power.PowerTrace` feeds the
Green500 L1/L2/L3 methodology and the paper-table benchmarks exactly
like a single-workload trace does.

The hot path is *interval-driven and vectorized* (ExaDigiT/RAPS style):
placement start/end events decompose the schedule into piecewise-
constant occupancy intervals, each interval is evaluated once through
the batched layer API, and the result is broadcast onto the ``dt_s``
sample grid — no per-tick × per-node × per-chip Python loops, which is
what makes the full 160-node / 640-GPU L-CSC topology with 1000+ jobs
tractable.  The per-tick loop survives as :func:`_merged_trace_reference`,
the equivalence-test oracle.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.cluster.scheduler import (ClusterTopology, Job,
                                           Schedule, Scheduler)
from repro_torch.cluster.workload import Workload, WorkloadResult
from repro_torch.power.model import OperatingPoint
from repro_torch.power.trace import PowerTrace, TraceRecorder


@dataclass
class ClusterRunResult:
    """One scheduled batch: placements, per-workload results, and the
    merged cluster-level power trace."""

    schedule: Schedule
    trace: PowerTrace
    results: List[WorkloadResult] = field(default_factory=list)

    @property
    def op(self) -> OperatingPoint:
        return self.schedule.op

    @property
    def makespan(self) -> float:
        return self.schedule.makespan

    def efficiency(self, level: int = 3):
        """Green500 measurement of the merged trace."""
        from repro_torch.power.green500 import measure_efficiency
        return measure_efficiency(self.trace, level)


def _op_table(schedule: Schedule):
    """Per-chip power/rate scaffolding shared by the vectorized engine
    and the loop oracle: ``(node, w_busy, w_idle, chip_peak_gflops)``
    where ``w_busy`` maps every distinct placement operating point (plus
    the schedule reference) to its busy-chip watts — the per-bin lookup
    table the heterogeneous trace indexes into.

    ``chip_peak_gflops`` is anchored at the *fixed* Green500 reference
    point, not ``schedule.op``: ``Placement.rate_per_chip`` already
    carries each job's clock-for-perf scaling (``op_rate_scale``), so a
    compute-bound placement at 900 MHz produces exactly the engine's
    900 MHz peak, while the delivered FLOPS of a memory-bound job is
    invariant to the clock it happens to run at — the paper's thesis."""
    from repro_torch.power.engine import node_hpl_gflops
    from repro_torch.power.layers import NodeModel

    node = NodeModel()
    gpu = node.gpus[0]
    ref = schedule.op
    ops = {ref} | {p.op for p in schedule.placements if p.op is not None}
    w_busy = {o: gpu.power(o, load=1.0) for o in ops}
    return (node, w_busy, gpu.power(ref, load=0.0),
            node_hpl_gflops(OperatingPoint.green500(), node)
            / schedule.topology.gpus_per_node)


def _sample_grid(span: float, dt_s: float) -> np.ndarray:
    """Grid over [0, span], ending exactly at the span (the final sample
    reports the busy state just before it — the left limit — so the
    trapezoid energy covers the full last interval and nothing after the
    batch is billed)."""
    ts = np.arange(0.0, span, dt_s)
    if not ts.size or ts[-1] < span:
        ts = np.append(ts, span)
    return ts


def _stamp_cluster_meta(trace: PowerTrace, schedule: Schedule) -> None:
    op = schedule.op
    clocks = sorted({(p.op or op).f_mhz for p in schedule.placements}
                    | {op.f_mhz})
    trace.meta.update(
        n_nodes=schedule.topology.n_nodes,
        policy=schedule.meta.get("policy", ""),
        operating_point={"f_mhz": op.f_mhz, "vid": op.vid, "fan": op.fan,
                         "nb": op.nb, "lookahead": op.lookahead},
        placement_clocks_mhz=clocks,
        heterogeneous=len(clocks) > 1)


def _merged_trace(schedule: Schedule, *, dt_s: float,
                  network_w: float) -> PowerTrace:
    """Vectorized interval-driven merge: busy chips draw dynamic power
    and produce FLOPS at their placement's effective rate, idle chips
    draw static power, and hosts/fans/PSU losses are charged whether or
    not a node is busy (the cluster is powered on).

    The trace is piecewise-constant between placement start/end events,
    so each distinct occupancy interval is evaluated **once** through
    the batched layer API and then broadcast onto the ``dt_s`` grid —
    sample-for-sample (bit-level) identical to the per-tick loop oracle
    :func:`_merged_trace_reference`.

    Heterogeneous batches: each placement stamps its own operating
    point's busy watts (from the shared per-op lookup table) onto its
    chips, so one interval matrix carries e.g. 900 MHz HPL nodes next
    to 774 MHz LQCD nodes; idle chips and the node's host/fan/PSU
    composition stay at the schedule reference point."""
    top = schedule.topology
    op = schedule.op
    node, w_busy, w_idle, chip_peak_gflops = _op_table(schedule)
    g = top.gpus_per_node
    n_chips = top.n_chips

    # a zero-work batch still gets a one-interval idle trace; a short
    # batch ends at its makespan, never padded out to dt_s
    span = schedule.makespan or dt_s

    # -- event decomposition: occupancy is constant between placement
    #    start/end events, so those times bound the evaluation intervals
    events = {0.0}
    live = [p for p in schedule.placements if p.end > p.start]
    for p in live:
        events.add(p.start)
        events.add(p.end)
    starts = np.array(sorted(e for e in events if 0.0 <= e < span))
    n_int = starts.shape[0]

    # -- per-chip piecewise-constant occupancy / watts / flops-rate
    #    matrices.  Later placements overwrite earlier ones on a shared
    #    chip, matching Schedule.active_chips' last-wins dict semantics;
    #    each placement writes its own op's busy watts.
    active = np.zeros((n_int, n_chips), dtype=bool)
    rate = np.zeros((n_int, n_chips))
    chip_w = np.full((n_int, n_chips), w_idle)
    for p in live:
        s = int(np.searchsorted(starts, p.start, side="left"))
        e = int(np.searchsorted(starts, p.end, side="left"))
        active[s:e, p.chips] = True
        rate[s:e, p.chips] = chip_peak_gflops * p.rate_per_chip
        chip_w[s:e, p.chips] = w_busy[p.op or op]

    # -- one batched layer evaluation per interval: per-node GPU DC draw
    #    (summed over the chip axis exactly like the scalar API sums its
    #    per-chip overrides), then the node composition elementwise
    gpu_dc = np.sum(chip_w.reshape(n_int, top.n_nodes, g), axis=2)
    per_node = node.component_watts_series(op, gpu_dc=gpu_dc)
    watts_int = {name: np.sum(w, axis=1) for name, w in per_node.items()}
    flops_int = np.sum(rate, axis=1)
    util_int = np.sum(active, axis=1) / n_chips

    # -- broadcast onto the dt_s grid: each sample reads the interval it
    #    falls in (the final sample at t == span reads the left limit);
    #    the piecewise-constant ingestion lives on the recorder so the
    #    online simulator's event boundaries ride the same path
    watts_int["network"] = np.full(n_int, float(network_w))
    rec = TraceRecorder(source="cluster.run")
    rec.emit_intervals(starts, watts_int, span=span, dt_s=dt_s,
                       flops_rate=flops_int, util=util_int,
                       f_mhz=op.f_mhz, fan=op.fan)
    trace = rec.trace()
    _stamp_cluster_meta(trace, schedule)
    return trace


def _merged_trace_reference(schedule: Schedule, *, dt_s: float,
                            network_w: float) -> PowerTrace:
    """The legacy per-tick ``ticks × nodes × chips`` Python loop over the
    *scalar* layer API — kept as the equivalence-test oracle for the
    vectorized engine.

    Per-tick values are accumulated into per-node/per-chip arrays and
    reduced with ``np.sum`` so the float association matches the
    vectorized engine's axis reductions bit-for-bit.  Per-placement
    operating points read the same busy-watts lookup table the
    vectorized engine indexes, chip by chip."""
    top = schedule.topology
    op = schedule.op
    node, w_busy, w_idle, chip_peak_gflops = _op_table(schedule)
    g = top.gpus_per_node

    span = schedule.makespan or dt_s
    rec = TraceRecorder(source="cluster.run")
    for t in _sample_grid(span, dt_s):
        active = schedule.active_chips(min(t, span - 1e-9))
        per_node: Dict[str, np.ndarray] = {
            name: np.zeros(top.n_nodes)
            for name in ("gpu", "host", "fan", "psu_loss")}
        f_chip = np.zeros(top.n_chips)
        busy = 0
        for n in range(top.n_nodes):
            overrides = []
            for c in range(n * g, (n + 1) * g):
                p = active.get(c)
                overrides.append(w_busy[p.op or op] if p is not None
                                 else w_idle)
                if p is not None:
                    f_chip[c] = chip_peak_gflops * p.rate_per_chip
                    busy += 1
            for name, w in node.component_watts(
                    op, gpu_w_override=overrides).items():
                per_node[name][n] = w
        watts = {name: float(np.sum(col)) for name, col in per_node.items()}
        watts["network"] = network_w
        rec.emit(t, watts, flops_rate=float(np.sum(f_chip)),
                 util=busy / top.n_chips, f_mhz=op.f_mhz, fan=op.fan)
    trace = rec.trace()
    _stamp_cluster_meta(trace, schedule)
    return trace


def run(workloads: Sequence[Union[Workload, Job]], *,
        policy: str = "packed",
        topology: Optional[ClusterTopology] = None,
        op: Optional[OperatingPoint] = None,
        power_cap_w: Optional[float] = None,
        network_w: Optional[float] = None,
        dt_s: float = 5.0,
        execute: bool = True) -> ClusterRunResult:
    """Schedule a mixed batch and merge its telemetry.

    ``workloads`` may mix :class:`Workload` adapters (their ``job()``
    spec is placed; with ``execute=True`` their real code path also runs
    and contributes a :class:`WorkloadResult`) and bare :class:`Job`
    specs (placed and power-modeled only — the cluster-scale path).

    Each job's operating point is resolved individually (explicit ``op``
    override → the job's ``preferred_op`` → the Green500 point); a
    ``power_cap_w`` derates each point down the DPM ladder.  The merged
    cluster trace carries component watts for every node — busy or idle —
    plus the separately-metered switches, pricing each placement at its
    own point.
    """
    if not workloads:
        raise ValueError("empty workload batch: nothing to run "
                         "(Scheduler.schedule accepts an empty job list "
                         "if you only need a placement)")
    jobs: List[Job] = []
    adapters: List[tuple] = []            # (workload, its job spec)
    for w in workloads:
        if isinstance(w, Job):
            jobs.append(w)
        else:
            job = w.job()
            jobs.append(job)
            adapters.append((w, job))

    sched = Scheduler(topology, policy=policy, power_cap_w=power_cap_w)
    schedule = sched.schedule(jobs, op=op)
    schedule.meta["policy"] = policy

    if network_w is None:
        network_w = schedule.topology.network_w

    trace = _merged_trace(schedule, dt_s=dt_s, network_w=float(network_w))

    results: List[WorkloadResult] = []
    if execute:
        # each adapter runs at the point its placement resolved to —
        # the same object identity the scheduler placed
        op_by_job = {id(p.job): p.op for p in schedule.placements}
        for wl, job in adapters:
            results.append(wl.execute(op_by_job.get(id(job))
                                      or schedule.op))
    return ClusterRunResult(schedule, trace, results)
