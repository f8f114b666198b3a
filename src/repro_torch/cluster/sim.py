"""Online discrete-event cluster simulator: arrival queues, FCFS +
conservative backfill, Weibull node failures with requeue (a copy of
the JAX package's ``cluster/sim.py``).

The paper's Green500 story is a snapshot of a *live* machine — L-CSC ran
as an operated cluster where jobs arrive, nodes fail and power varies
over time, not as one closed batch.  This module turns
``cluster.run(jobs, policy)`` into that RAPS-style online operation:

  * an **arrival queue** (trace- or Poisson-driven submit times,
    :mod:`repro_torch.cluster.events`) feeds a wait queue;
  * the **dispatcher** places FCFS, optionally with conservative
    (EASY-style) backfill: a blocked queue head gets a chip reservation
    at its earliest projected start, and later jobs may jump ahead only
    onto chips outside that reservation or if they finish before it —
    so backfill never delays the head;
  * **node failures** are drawn from the shared
    :class:`repro_torch.distributed.fault.WeibullFailureModel` renewal
    process; a failure kills the placements on that node mid-flight
    (the power they burned stays on the trace), requeues the jobs at
    their original queue position, and returns the node after its
    repair time;
  * the event loop only produces **interval boundaries** — placements
    are piecewise-constant between events — so the merged cluster power
    rides the vectorized interval engine
    (:func:`repro_torch.cluster.run._merged_trace`) unchanged, and 160 nodes
    × weeks of simulated time stays interactive.

Determinism: everything stochastic (arrival gaps, failure draws) comes
from seeded generators, so a ``(arrivals, seed)`` pair replays exactly.

Oracle property: with every
arrival at t=0, no failures, and placement choices that share the batch
scheduler's tie-breaks (:class:`repro_torch.cluster.scheduler.ChipPool`), the
simulator's merged ``PowerTrace`` is bit-identical to the closed-batch
``cluster.run()`` trace.
"""
from __future__ import annotations

import heapq
import math
from bisect import insort
from dataclasses import dataclass, field
from itertools import count
from typing import Dict, List, Optional, Tuple

from repro_torch.cluster.events import (ARRIVE, FAIL, FINISH, REPAIR, Arrival,
                                  ArrivalsLike, as_arrivals)
from repro_torch.cluster.resilience import AttemptPlan, CheckpointPolicy
from repro_torch.cluster.run import _merged_trace
from repro_torch.cluster.scheduler import (ChipPool, ClusterTopology,
                                     GREEN500_TOPOLOGY, MULTI_GPU_SLOWDOWN,
                                     Placement, Schedule, Scheduler,
                                     _commit_placement, _reference_op,
                                     op_rate_scale, synchronous_rate)
from repro_torch.cluster.stats import (COMPLETED, DEFAULT_USD_PER_KWH, DROPPED,
                                 JobRecord, SimStats, compute_stats)
from repro_torch.distributed.fault import WeibullFailureModel
from repro_torch.power.model import OperatingPoint
from repro_torch.power.trace import PowerTrace


@dataclass
class SimResult:
    """One simulated run: the as-executed schedule (every placement,
    including failure-truncated attempts), the merged cluster power
    trace, the RAPS-style stats block, and the per-job records."""

    schedule: Schedule
    trace: PowerTrace
    stats: SimStats
    records: List[JobRecord] = field(default_factory=list)
    # uid → WorkloadResult for completed Workload-backed arrivals, when
    # simulate(..., execute=True) ran them at their placement's op
    results: Dict[int, object] = field(default_factory=dict)
    # every (node, t_down, t_up) drawn during the run — matches the
    # eager WeibullFailureModel.node_outages(seed, ...) draw-for-draw
    outages: List[Tuple[int, float, float]] = field(default_factory=list)

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


@dataclass
class _Attempt:
    """One running placement attempt: the committed placement, its job
    record, the attempt ordinal (stale-FINISH guard), and — with a
    :class:`CheckpointPolicy` — its checkpoint schedule."""

    placement: Placement
    rec: JobRecord
    attempt: int
    plan: Optional[AttemptPlan] = None


class _Sim:
    """The event loop's mutable state (one run, then discarded)."""

    def __init__(self, arrivals: List[Arrival], *,
                 topology: ClusterTopology, policy: str, backfill: bool,
                 op: Optional[OperatingPoint], power_cap_w: Optional[float],
                 failure_model: Optional[WeibullFailureModel], seed: int,
                 max_requeues: int, penalty: float,
                 checkpoint: Optional[CheckpointPolicy] = None,
                 elastic: bool = False):
        self.topology = topology
        self.backfill = backfill
        self.failure_model = failure_model
        self.max_requeues = max_requeues
        self.penalty = penalty
        self.checkpoint = checkpoint
        self.elastic = elastic

        sched = Scheduler(topology, policy=policy,
                          power_cap_w=power_cap_w,
                          multi_gpu_penalty=penalty)
        self.sched = sched              # elastic restarts re-resolve here
        self.op_arg = op
        jobs = [a.job for a in arrivals]
        # per-job operating points, resolved up front exactly like the
        # batch scheduler (explicit op → preferred_op → autotuner pick,
        # each derated under the cap); self.op is the batch reference
        self.op, self.derated = sched.resolve_operating_point(op)
        self.job_ops: List[OperatingPoint] = []
        for j in jobs:
            job_op, job_derated = sched.resolve_operating_point(op, job=j)
            self.job_ops.append(job_op)
            self.derated = self.derated or job_derated
        # chip widths validated up front: an unplaceable job fails the
        # submit, exactly like the batch scheduler
        self.need = [sched._chips_needed(j) for j in jobs]
        # the memory floor — elastic restarts may shrink a requeued
        # attempt down to this width when the full pool isn't available
        self.min_need = [max(1, math.ceil(j.mem_gb / topology.gpu_mem_gb))
                         for j in jobs]

        self.pool = ChipPool(topology, policy=policy)
        self.records = [JobRecord(uid, a.job, a.t)
                        for uid, a in enumerate(arrivals)]
        self.queue: List[JobRecord] = []        # (submit_s, uid)-sorted
        self.running: Dict[int, _Attempt] = {}
        self.placements: List[Placement] = []
        self.heap: List[tuple] = []
        self._seq = count()
        self.pending_arrivals = len(arrivals)
        self.queue_peak = 0
        self.n_failures = 0
        self.downtime_s = 0.0
        self.outages: List[Tuple[int, float, float]] = []

        # resilience accounting (all stay 0 without failures)
        self.wasted_chip_s = 0.0
        self.wasted_node_s = 0.0
        self.wasted_energy_j = 0.0
        self.ckpt_count = 0
        self.ckpt_overhead_s = 0.0
        self.ckpt_overhead_chip_s = 0.0
        self.ckpt_energy_j = 0.0
        # absolute (t0, t1, watts) storage-write windows for the trace
        self.ckpt_windows: List[Tuple[float, float, float]] = []
        self._busy_w: Dict[OperatingPoint, float] = {}

        for a, rec in zip(arrivals, self.records):
            self._push(a.t, ARRIVE, ("arrive", rec.uid))
        if failure_model is not None:
            # one SeedSequence-spawned stream per node: node i's uptime
            # sequence depends only on (seed, i), so the eager
            # node_outages(seed, ...) iterator replays these draws
            self.node_rng = failure_model.node_streams(seed,
                                                       topology.n_nodes)
            for node in range(topology.n_nodes):
                self._push(failure_model.draw_uptime_s(self.node_rng[node]),
                           FAIL, ("fail", node))

    # -- plumbing ------------------------------------------------------------

    def _push(self, t: float, prio: int, payload: tuple) -> None:
        heapq.heappush(self.heap, (t, prio, next(self._seq), payload))

    def _enqueue(self, rec: JobRecord) -> None:
        rec.state = "queued"
        # requeued jobs keep their original queue position (submit time)
        insort(self.queue, rec, key=lambda r: (r.submit_s, r.uid))
        self.queue_peak = max(self.queue_peak, len(self.queue))

    # -- resilience helpers --------------------------------------------------

    def _chip_busy_w(self, op: Optional[OperatingPoint]) -> float:
        """Busy watts per chip at ``op`` — the same GPU model figure the
        trace engine prices placements at (:func:`run._op_table`)."""
        op = op or self.op
        w = self._busy_w.get(op)
        if w is None:
            from repro_torch.power.layers import NodeModel
            w = NodeModel().gpus[0].power(op, load=1.0)
            self._busy_w[op] = w
        return w

    def _plan_for(self, rec: JobRecord, pool_chips,
                  op: OperatingPoint, rate: float) -> Optional[AttemptPlan]:
        """This attempt's checkpoint schedule (None without a policy).
        The interval comes from the Daly formula at the placement's node
        span; the remaining-work seconds match ``_commit_placement``'s
        arithmetic exactly so the plan and the placement agree."""
        if self.checkpoint is None:
            return None
        job = rec.job
        scale = 1.0 - rec.completed_fraction
        work = job.work_units if scale == 1.0 else job.work_units * scale
        mtbf = (self.failure_model.mtbf_s
                if self.failure_model is not None else math.inf)
        n_nodes = len({c.node_id for c in pool_chips})
        tau = self.checkpoint.interval_for(job, n_nodes=n_nodes,
                                           mtbf_node_s=mtbf)
        return AttemptPlan(work / rate, tau,
                           self.checkpoint.write_time_s(job))

    def _book_checkpoints(self, p: Placement, plan: AttemptPlan,
                          until_s: Optional[float] = None) -> int:
        """Bill ``plan``'s write windows (clipped at a kill) onto the
        storage accounting and return how many *completed* — only those
        preserve progress, but a truncated write still burned power."""
        wins = plan.checkpoint_windows(until_s)
        if not wins:
            return 0
        g = self.topology.gpus_per_node
        n_nodes = len({c // g for c in p.chips})
        w_node = self.checkpoint.write_w * n_nodes
        full = 0
        for w0, w1 in wins:
            dur = w1 - w0
            if dur >= plan.delta_s - 1e-9:
                full += 1
            self.ckpt_overhead_s += dur
            self.ckpt_overhead_chip_s += dur * len(p.chips)
            self.ckpt_energy_j += dur * w_node
            self.ckpt_windows.append((p.start + w0, p.start + w1, w_node))
        self.ckpt_count += full
        return full

    # -- event handlers ------------------------------------------------------

    def _start(self, rec: JobRecord, pool_chips, t: float) -> None:
        op = self.job_ops[rec.uid]
        if len(pool_chips) != self.need[rec.uid]:
            # elastic restart on a narrower surviving pool: re-resolve
            # the operating point for the attempt's actual width
            op, d = self.sched.resolve_operating_point(self.op_arg,
                                                       job=rec.job)
            self.derated = self.derated or d
        plan = None
        extra = 0.0
        scale = 1.0 - rec.completed_fraction
        if self.checkpoint is not None:
            rate = (synchronous_rate([c.perf_scale for c in pool_chips],
                                     self.penalty)
                    * op_rate_scale(rec.job, op))
            plan = self._plan_for(rec, pool_chips, op, rate)
            extra = plan.overhead_s
        p = _commit_placement(rec.job, pool_chips, self.penalty, now=t,
                              op=op, work_scale=scale, extra_s=extra)
        self.placements.append(p)
        if rec.start_s is None:
            rec.start_s = p.start
        rec.state = "running"
        self.running[rec.uid] = _Attempt(p, rec, rec.requeues, plan)
        self._push(p.end, FINISH, ("finish", rec.uid, rec.requeues))

    def _on_finish(self, uid: int, attempt: int, t: float) -> None:
        a = self.running.get(uid)
        if a is None or a.attempt != attempt:
            return                      # stale: this attempt was killed
        del self.running[uid]
        rec = a.rec
        rec.state = COMPLETED
        rec.end_s = t
        rec.completed_fraction = 1.0
        if a.plan is not None:
            rec.checkpoints += self._book_checkpoints(a.placement, a.plan)

    def _on_fail(self, node: int, t: float) -> None:
        model = self.failure_model
        up_at = t + model.repair_s
        self.pool.fail_node(node, t, up_at)
        self._push(up_at, REPAIR, ("repair", node))
        self.n_failures += 1
        self.downtime_s += model.repair_s
        self.outages.append((node, t, up_at))
        g = self.topology.gpus_per_node
        victims = [uid for uid, a in self.running.items()
                   if any(c // g == node for c in a.placement.chips)]
        for uid in victims:
            a = self.running.pop(uid)
            p, rec = a.placement, a.rec
            elapsed = t - p.start
            frac0 = rec.completed_fraction
            if a.plan is not None:
                preserved_s, wasted_s = a.plan.progress_at(elapsed)
                if a.plan.work_s > 0.0 and preserved_s > 0.0:
                    # this attempt owed (1 - frac0) of the job; rounded
                    # *down* to the last completed checkpoint
                    rec.completed_fraction = min(
                        frac0 + preserved_s / a.plan.work_s * (1.0 - frac0),
                        1.0)
                rec.checkpoints += self._book_checkpoints(p, a.plan,
                                                          until_s=elapsed)
            else:
                wasted_s = min(max(elapsed, 0.0), p.end - p.start)
            self.wasted_chip_s += wasted_s * len(p.chips)
            self.wasted_node_s += wasted_s * len({c // g for c in p.chips})
            self.wasted_energy_j += (wasted_s * len(p.chips)
                                     * self._chip_busy_w(p.op))
            p.end = t                   # power burned up to the kill stays
            self.pool.release(p.chips, t)
            rec.requeues += 1
            if rec.requeues > self.max_requeues:
                rec.state = DROPPED
                rec.end_s = t
            else:
                self._enqueue(rec)

    def _on_repair(self, node: int, t: float) -> None:
        self.pool.repair_node(node, t)
        self._push(t + self.failure_model.draw_uptime_s(self.node_rng[node]),
                   FAIL, ("fail", node))

    # -- dispatcher ----------------------------------------------------------

    def _pick(self, rec: JobRecord, t: float,
              exclude: frozenset = frozenset()):
        """A free pool for ``rec`` — full width first; a requeued job
        may elastically shrink to its memory floor when enabled."""
        cand = self.pool.pick_now(self.need[rec.uid], t, exclude=exclude)
        if (cand is None and self.elastic and rec.requeues > 0
                and self.min_need[rec.uid] < self.need[rec.uid]):
            cand = self.pool.pick_now(self.min_need[rec.uid], t,
                                      exclude=exclude)
        return cand

    def _est_duration_s(self, rec: JobRecord, cand) -> float:
        """Projected attempt duration on ``cand`` (backfill's finish
        estimate) — identical arithmetic to what :meth:`_start` would
        commit, including remaining-fraction and checkpoint overhead."""
        op = self.job_ops[rec.uid]
        rate = (synchronous_rate([c.perf_scale for c in cand], self.penalty)
                * op_rate_scale(rec.job, op))
        plan = self._plan_for(rec, cand, op, rate)
        if plan is not None:
            return plan.duration_s
        return rec.job.work_units / rate

    def _dispatch(self, t: float) -> None:
        # FCFS: start queue heads while they fit right now
        while self.queue:
            rec = self.queue[0]
            cand = self._pick(rec, t)
            if cand is None:
                break
            self.queue.pop(0)
            self._start(rec, cand, t)
        if not (self.backfill and self.queue):
            return
        # conservative (EASY-style) backfill: reserve the blocked head's
        # earliest projected pool; later jobs may start now only on
        # chips outside the reservation, or on reserved chips if they
        # provably finish before the head's start
        head = self.queue[0]
        res_pool, t_res = self.pool.earliest_pool(self.need[head.uid])
        reserved = frozenset(c.chip_id for c in res_pool or ())
        i = 1
        while i < len(self.queue):
            rec = self.queue[i]
            cand = self._pick(rec, t, exclude=reserved)
            if cand is None:
                cand = self._pick(rec, t)
                if cand is not None:
                    if t + self._est_duration_s(rec, cand) > t_res:
                        cand = None
            if cand is None:
                i += 1
            else:
                self.queue.pop(i)
                self._start(rec, cand, t)

    # -- the loop ------------------------------------------------------------

    def run(self) -> None:
        heap = self.heap
        while heap:
            if not (self.queue or self.running or self.pending_arrivals):
                break                   # only failure churn left
            t = heap[0][0]
            batch = []
            while heap and heap[0][0] == t:
                batch.append(heapq.heappop(heap))
            for _, _, _, payload in batch:      # (t, prio, seq)-ordered
                kind = payload[0]
                if kind == "finish":
                    self._on_finish(payload[1], payload[2], t)
                elif kind == "fail":
                    self._on_fail(payload[1], t)
                elif kind == "repair":
                    self._on_repair(payload[1], t)
                else:                            # arrive
                    self.pending_arrivals -= 1
                    self._enqueue(self.records[payload[1]])
            self._dispatch(t)
        bad = [r for r in self.records
               if r.state not in (COMPLETED, DROPPED)]
        if bad:
            raise RuntimeError(
                f"simulation ended with {len(bad)} non-terminal jobs "
                f"(first: {bad[0].job.name!r} in state {bad[0].state!r}) — "
                f"event-loop invariant broken")


def _inject_storage(trace: PowerTrace,
                    windows: List[Tuple[float, float, float]]) -> None:
    """Add the checkpoint-write ``storage`` component to the merged
    trace: a step function that is ``watts`` inside each half-open
    ``[t0, t1)`` write window (overlapping windows sum).  Samples use
    the interval engine's convention — sample ``i`` covers
    ``[t[i], t[i+1])``, and the final boundary reads its left limit —
    so Green500 L1/L2/L3 integrate checkpoint energy honestly."""
    import numpy as np
    span = float(trace.t[-1])
    ts = np.minimum(np.asarray(trace.t, dtype=float), span - 1e-9)
    t_ev = np.array([w[0] for w in windows] + [w[1] for w in windows])
    dw = np.array([w[2] for w in windows] + [-w[2] for w in windows])
    order = np.argsort(t_ev, kind="stable")
    t_ev = t_ev[order]
    level = np.cumsum(dw[order])
    idx = np.searchsorted(t_ev, ts, side="right") - 1
    series = np.where(idx >= 0, level[np.clip(idx, 0, None)], 0.0)
    trace.components["storage"] = series


def simulate(arrivals: ArrivalsLike, *,
             topology: Optional[ClusterTopology] = None,
             policy: str = "packed",
             backfill: bool = True,
             op: Optional[OperatingPoint] = None,
             power_cap_w: Optional[float] = None,
             failure_model: Optional[WeibullFailureModel] = None,
             seed: int = 0,
             max_requeues: int = 3,
             multi_gpu_penalty: float = MULTI_GPU_SLOWDOWN,
             dt_s: float = 5.0,
             network_w: Optional[float] = None,
             usd_per_kwh: float = DEFAULT_USD_PER_KWH,
             checkpoint: Optional[CheckpointPolicy] = None,
             elastic: bool = False,
             execute: bool = False) -> SimResult:
    """Run the online simulator and return schedule + trace + stats.

    ``arrivals`` is anything :func:`repro_torch.cluster.events.as_arrivals`
    accepts: a plain job list (all submitted at t=0 — the batch-oracle
    case), ``(t, job)`` pairs, or an arrival process
    (:class:`PoissonArrivals`, :class:`TraceArrivals`).

    ``backfill=False`` is plain FCFS with head-of-line blocking;
    ``backfill=True`` adds conservative (EASY-style) backfill under the
    head's reservation.  ``failure_model`` turns on Weibull node
    failures with requeue (``seed`` drives the draws); jobs are dropped
    after ``max_requeues`` failure kills.  ``power_cap_w`` derates the
    operating point down the DPM ladder exactly like the batch
    scheduler, and the merged trace feeds Green500 L1/L2/L3 unchanged.

    Arrivals may also be ``Workload`` adapters (or ``(t,
    workload)`` pairs) — their ``job()`` spec is what gets placed,
    failed and requeued; with ``execute=True`` every *completed*
    workload is additionally executed at its final placement's resolved
    operating point and the results land in ``SimResult.results``
    (uid-keyed) — e.g. per-request serve stats from a
    :class:`repro_torch.serve.replay.ReplayServeWorkload` shard.

    ``checkpoint`` (a :class:`repro_torch.cluster.resilience.CheckpointPolicy`)
    makes every attempt pause for Daly-interval (or fixed-interval)
    checkpoint writes: killed attempts requeue with
    ``completed_fraction`` rounded down to the last completed write
    instead of zero, write energy lands on the trace as a ``storage``
    component, and wasted/checkpoint totals surface in ``SimStats``.
    ``elastic=True`` lets a requeued job restart on a narrower surviving
    pool (down to its memory floor) at a re-resolved operating point
    rather than waiting for its full width.
    """
    arr = as_arrivals(arrivals)
    if not arr:
        raise ValueError("empty arrival stream: nothing to simulate")
    topology = topology or GREEN500_TOPOLOGY
    sim = _Sim(arr, topology=topology, policy=policy, backfill=backfill,
               op=op, power_cap_w=power_cap_w, failure_model=failure_model,
               seed=seed, max_requeues=max_requeues, penalty=multi_gpu_penalty,
               checkpoint=checkpoint, elastic=elastic)
    sim.run()

    schedule = Schedule(sim.placements, _reference_op(sim.placements, sim.op),
                        topology, derated=sim.derated)
    schedule.meta["policy"] = policy
    if network_w is None:
        network_w = topology.network_w
    trace = _merged_trace(schedule, dt_s=dt_s, network_w=float(network_w))
    trace.meta.update(online=True, backfill=backfill,
                      failures=sim.n_failures)
    if sim.ckpt_windows:
        # only when ≥1 write actually happened — the no-failure oracle
        # (MTBF=∞ ⇒ zero checkpoints) keeps the batch component set
        _inject_storage(trace, sim.ckpt_windows)
    stats = compute_stats(sim.records, sim.placements, trace, topology,
                          node_failures=sim.n_failures,
                          node_downtime_s=sim.downtime_s,
                          queue_peak=sim.queue_peak,
                          usd_per_kwh=usd_per_kwh,
                          wasted_chip_s=sim.wasted_chip_s,
                          wasted_node_s=sim.wasted_node_s,
                          wasted_energy_j=sim.wasted_energy_j,
                          checkpoints=sim.ckpt_count,
                          checkpoint_overhead_s=sim.ckpt_overhead_s,
                          checkpoint_overhead_chip_s=sim.ckpt_overhead_chip_s,
                          checkpoint_energy_j=sim.ckpt_energy_j)
    results: Dict[int, object] = {}
    if execute:
        # last placement wins for requeued jobs — that attempt completed
        op_by_job = {id(p.job): (p.op or sim.op) for p in sim.placements}
        for a, rec in zip(arr, sim.records):
            if a.workload is None or rec.state != COMPLETED:
                continue
            results[rec.uid] = a.workload.execute(
                op_by_job.get(id(a.job), sim.op))
    return SimResult(schedule, trace, stats, sim.records, results,
                     outages=sim.outages)
