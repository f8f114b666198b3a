"""Power-aware cluster scheduler (paper §1–2), RAPS-style: a copy of the
JAX package's ``cluster/scheduler.py``.

A topology-aware scheduler the Workload API feeds:

  * "run most lattices on a single GPU; use all four GPUs of a node for
    independent lattices" — the ``packed`` policy prefers chip-local
    placement and only shards a job when it exceeds single-chip memory,
    keeping the shards on as few nodes as possible and charging the
    published ~20% multi-GPU penalty;
  * "multi-node HPL distributes work evenly, so the slowest node dictates
    performance" — sharded jobs advance at synchronous-step pace,
    ``n_chips × min(perf_scale)``, not the optimistic sum;
  * a cluster power cap is enforced by derating the operating point down
    the S9150's DPM ladder (the autotuner's discrete frequency states)
    until the full-load cluster draw fits — the paper's own mechanism
    for staying inside the facility budget.

The legacy straggler-mitigation helpers (frequency flooring, pod
dropping) ride along unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.lcsc_lqcd import (GREEN500_SWITCH_POWER_W,
                                           MULTI_GPU_SLOWDOWN)
from repro_torch.power.model import OperatingPoint

# The S9150 (Hawaii) exposes a small set of firmware DPM clock states;
# 774 MHz is the one the paper locked for the Green500 run.  A copy of
# the JAX package's ``autotune/space.py`` ladder: the power cap derates
# down these supported states, not a continuum.
S9150_DPM_STATES_MHZ: Tuple[float, ...] = (300.0, 457.0, 562.0, 662.0,
                                           774.0, 851.0, 900.0)


class SchedulingError(ValueError):
    """A job batch cannot be placed on the topology at all."""


class PowerCapError(SchedulingError):
    """No supported operating point fits the requested power cap."""


@dataclass(frozen=True)
class Job:
    """One schedulable unit of work — the normalized spec every
    :class:`repro_torch.cluster.workload.Workload` adapter emits.

    ``work_units`` is relative wall-clock on one reference chip at the
    reference operating point; ``preferred_op`` lets a workload ask for
    its own operating point (the scheduler may still derate it to meet a
    cluster power cap).  ``state_bytes`` is the checkpointable state a
    restart needs (``Workload.state_bytes()`` fills it in); ``None``
    falls back to the resident working set (the JAX package's
    ``cluster/resilience.py::job_state_bytes``, not ported yet)."""

    name: str
    mem_gb: float
    work_units: float
    shardable: bool = True
    preferred_op: Optional[OperatingPoint] = None
    kind: str = "generic"
    state_bytes: Optional[float] = None


@dataclass
class Chip:
    chip_id: int
    mem_gb: float
    perf_scale: float = 1.0      # chip-to-chip variation
    busy_until: float = 0.0
    node_id: int = 0


@dataclass
class Placement:
    job: Job
    chips: List[int]
    start: float
    end: float
    sharded: bool
    nodes: Tuple[int, ...] = ()
    rate_per_chip: float = 1.0   # effective work rate per chip (ref = 1.0)
    op: Optional[OperatingPoint] = None   # per-job point; None = schedule ref


@dataclass(frozen=True)
class ClusterTopology:
    """The machine the scheduler places onto: L-CSC is 160 nodes of
    4×S9150 (16 GB each); the Green500 run used a 56-node subset.
    ``network_w`` is the separately-metered switch draw (paper §3:
    257 W), charged at the wall whatever the nodes do."""

    n_nodes: int = 160
    gpus_per_node: int = 4
    gpu_mem_gb: float = 16.0
    perf_scales: Optional[Tuple[float, ...]] = None   # per chip, else 1.0
    network_w: float = GREEN500_SWITCH_POWER_W

    @property
    def n_chips(self) -> int:
        return self.n_nodes * self.gpus_per_node

    @property
    def node_mem_gb(self) -> float:
        return self.gpus_per_node * self.gpu_mem_gb

    def chips(self) -> List[Chip]:
        scales = self.perf_scales or (1.0,) * self.n_chips
        if len(scales) != self.n_chips:
            raise ValueError(f"need {self.n_chips} perf scales, got "
                             f"{len(scales)}")
        return [Chip(i, self.gpu_mem_gb, float(scales[i]),
                     node_id=i // self.gpus_per_node)
                for i in range(self.n_chips)]


GREEN500_TOPOLOGY = ClusterTopology(n_nodes=56)
L_CSC_TOPOLOGY = ClusterTopology(n_nodes=160)


@dataclass
class Schedule:
    """The scheduler's output: placements plus the operating point the
    batch actually runs at (possibly derated to meet the power cap)."""

    placements: List[Placement]
    op: OperatingPoint
    topology: ClusterTopology
    derated: bool = False
    meta: Dict[str, float] = field(default_factory=dict)

    @property
    def makespan(self) -> float:
        return max((p.end for p in self.placements), default=0.0)

    def active_chips(self, t: float) -> Dict[int, Placement]:
        """chip_id → placement running on it at time ``t``."""
        out: Dict[int, Placement] = {}
        for p in self.placements:
            if p.start <= t < p.end:
                for c in p.chips:
                    out[c] = p
        return out


def synchronous_rate(perf_scales: Sequence[float],
                     penalty: float = MULTI_GPU_SLOWDOWN) -> float:
    """Aggregate work rate of a sharded job: every synchronous step is
    paced by the slowest shard, so the pool delivers
    ``n × min(perf) × (1 − penalty)`` — not the sum of its chips."""
    scales = list(perf_scales)
    if len(scales) == 1:
        return scales[0]
    return len(scales) * min(scales) * (1.0 - penalty)


# Workload kinds whose runtime the paper measures as clock-insensitive
# (LQCD: <1.5% across the DPM ladder — memory-bound); everything else
# (HPL, generic compute) scales with the engine's HPL perf curve.
# serve_replay: decode-dominated request replay (the JAX package's
# ``serve``) — same bandwidth-bound physics as serve.
MEMORY_BOUND_KINDS = frozenset({"lqcd", "serve", "serve_replay",
                                "synthetic"})

_RATE_SCALE_CACHE: Dict[OperatingPoint, float] = {}


def op_rate_scale(job: Job, op: Optional[OperatingPoint]) -> float:
    """Work-rate multiplier for running ``job`` at ``op`` instead of the
    Green500 reference point ``Job.work_units`` is calibrated against.

    Memory-bound kinds run at 1.0 regardless of clock (the paper's LQCD
    thesis); compute-bound kinds scale by the engine's node-HPL perf at
    ``op`` over the same figure at the reference — so a 900 MHz HPL
    placement finishes in the published clock-for-perf ratio.  Exactly
    1.0 at the reference point itself, keeping pre-heterogeneous
    schedules bit-identical."""
    ref = OperatingPoint.green500()
    if op is None or op == ref or job.kind in MEMORY_BOUND_KINDS:
        return 1.0
    scale = _RATE_SCALE_CACHE.get(op)
    if scale is None:
        from repro_torch.power.engine import node_hpl_gflops
        scale = node_hpl_gflops(op) / node_hpl_gflops(ref)
        _RATE_SCALE_CACHE[op] = scale
    return scale


def _commit_placement(job: Job, pool: List[Chip],
                      penalty: float, *,
                      now: Optional[float] = None,
                      op: Optional[OperatingPoint] = None,
                      work_scale: float = 1.0,
                      extra_s: float = 0.0) -> Placement:
    """Book ``job`` onto ``pool``: earliest common start, synchronous-step
    pacing, busy_until advanced on every chip.  The one placement
    definition the Scheduler, the online simulator, and the legacy flat
    API all use.  ``now`` clamps the start to the current simulation
    time (an online dispatch can't start in the past); the batch path
    leaves it unset.  ``op`` is the job's resolved operating point: it
    both rides on the placement (the trace engine prices each interval
    at its placement's point) and paces the work via
    :func:`op_rate_scale`.

    The resilience layer books *partial* attempts: ``work_scale`` is
    the fraction of ``work_units`` still owed after checkpoint-restored
    progress, and ``extra_s`` appends checkpoint-write pause seconds to
    the duration.  ``rate_per_chip`` then reflects the *effective*
    delivered rate over the whole attempt (compute work / total wall),
    so the trace engine's FLOPS stay honest during write pauses.  The
    defaults leave the arithmetic bit-identical to the pre-resilience
    path."""
    start = max(c.busy_until for c in pool)
    if now is not None and now > start:
        start = now
    rate = (synchronous_rate([c.perf_scale for c in pool], penalty)
            * op_rate_scale(job, op))
    work = job.work_units if work_scale == 1.0 \
        else job.work_units * work_scale
    dur = work / rate
    rate_chip = rate / len(pool)
    if extra_s > 0.0:
        dur += extra_s
        rate_chip = (work / dur) / len(pool)
    for c in pool:
        c.busy_until = start + dur
    return Placement(job, [c.chip_id for c in pool], start, start + dur,
                     len(pool) > 1,
                     nodes=tuple(sorted({c.node_id for c in pool})),
                     rate_per_chip=rate_chip, op=op)


def _reference_op(placements: Sequence[Placement],
                  fallback: OperatingPoint) -> OperatingPoint:
    """A schedule's single reference point: the unique per-placement op
    when the batch is homogeneous (so ``Schedule.op`` stays exact for
    single-point batches), else ``fallback`` — heterogeneous batches
    keep their per-placement ops and the reference only anchors idle
    power, fan and metadata."""
    ops = {p.op for p in placements if p.op is not None}
    if len(ops) == 1:
        return next(iter(ops))
    return fallback


class Scheduler:
    """Greedy list scheduler over a :class:`ClusterTopology`.

    Policies:
      * ``packed`` — chip-local packing: single-chip placement unless the
        job's memory demands sharding; shards stay on the fewest nodes.
      * ``round_robin`` — the naive baseline: every shardable job is
        spread over one node's worth of GPUs, striped round-robin across
        nodes, always paying the multi-GPU penalty.
    """

    POLICIES = ("packed", "round_robin")

    def __init__(self, topology: Optional[ClusterTopology] = None, *,
                 policy: str = "packed",
                 multi_gpu_penalty: float = MULTI_GPU_SLOWDOWN,
                 power_cap_w: Optional[float] = None):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"choose from {self.POLICIES}")
        self.topology = topology or GREEN500_TOPOLOGY
        self.policy = policy
        self.penalty = multi_gpu_penalty
        self.power_cap_w = power_cap_w
        self._auto_op: Optional[OperatingPoint] = None
        self._derate_cache: Dict[OperatingPoint,
                                 Tuple[OperatingPoint, bool]] = {}

    # -- power cap ---------------------------------------------------------

    def resolve_operating_point(self, op: Optional[OperatingPoint] = None,
                                job: Optional[Job] = None,
                                ) -> Tuple[OperatingPoint, bool]:
        """Resolve the operating point one job (or the batch reference,
        when ``job`` is None) actually runs at.  Resolution order:
        explicit ``op`` override → the job's ``preferred_op`` → the
        Green500 point (:meth:`_recommended_op`) — then derated
        down the S9150 DPM ladder until the full-load cluster draw fits
        the power cap.  Returns ``(op, derated)``.  Every job's
        preference is honored individually: nothing is coerced onto a
        batch-wide point any more."""
        if op is None and job is not None and job.preferred_op is not None:
            op = job.preferred_op
        if op is None:
            op = self._recommended_op()
        if self.power_cap_w is None:
            return op, False
        return self._derate(op)

    def _recommended_op(self) -> OperatingPoint:
        """The operating point for jobs with no preference: the paper's
        Green500 point, which the JAX package's autotuner cost model
        rediscovers.  The port has no autotuner yet (ROADMAP A5)."""
        if self._auto_op is None:
            self._auto_op = OperatingPoint.green500()
        return self._auto_op

    def _derate(self, op: OperatingPoint) -> Tuple[OperatingPoint, bool]:
        """Walk ``op`` down the S9150 DPM ladder (the autotuner's
        discrete frequency states) until the full-load cluster draw fits
        the cap.  Conservative per-job check: the whole cluster at this
        job's point must fit, so any mix of admitted points also fits."""
        cached = self._derate_cache.get(op)
        if cached is not None:
            return cached
        # the requested clock itself, then every DPM state below it (an
        # op already under the lowest state has nowhere left to derate)
        ladder = sorted({op.f_mhz}
                        | {f for f in S9150_DPM_STATES_MHZ if f < op.f_mhz},
                        reverse=True)
        for f in ladder:
            cand = op.replace(f_mhz=float(f))
            if self._full_load_power(cand) <= self.power_cap_w:
                self._derate_cache[op] = (cand, f != op.f_mhz)
                return cand, f != op.f_mhz
        floor = self._full_load_power(op.replace(f_mhz=float(ladder[-1])))
        raise PowerCapError(
            f"power cap {self.power_cap_w:.0f} W infeasible: the lowest "
            f"reachable clock ({ladder[-1]:.0f} MHz) still draws "
            f"{floor:.0f} W at full load on {self.topology.n_nodes} nodes")

    def _full_load_power(self, op: OperatingPoint) -> float:
        """Worst-case wall draw the cap is checked against: every node at
        full load, plus the switches (they count at the wall too)."""
        from repro_torch.power.layers import NodeModel
        return NodeModel().power(op) * self.topology.n_nodes \
            + self.topology.network_w

    # -- placement ---------------------------------------------------------

    def schedule(self, jobs: Sequence[Job], *,
                 op: Optional[OperatingPoint] = None) -> Schedule:
        """Place ``jobs`` (largest first), resolving each job's operating
        point individually (see :meth:`resolve_operating_point`).  An
        explicit ``op`` overrides every preference — the pre-existing
        "force the batch to one point" knob.  ``Schedule.op`` is the
        single point when the batch is homogeneous, else the resolved
        batch reference; per-placement points ride on
        ``Placement.op``."""
        ref, derated = self.resolve_operating_point(op)
        chips = self.topology.chips()
        placements: List[Placement] = []
        for job in sorted(jobs, key=lambda j: -j.work_units):
            job_op, job_derated = self.resolve_operating_point(op, job=job)
            derated = derated or job_derated
            placements.append(self._place(job, chips, op=job_op))
        return Schedule(placements, _reference_op(placements, ref),
                        self.topology, derated=derated)

    def _chips_needed(self, job: Job) -> int:
        need = max(1, math.ceil(job.mem_gb / self.topology.gpu_mem_gb))
        if need > 1 and not job.shardable:
            raise SchedulingError(
                f"job {job.name!r} needs {job.mem_gb:.1f} GB but is not "
                f"shardable (chip memory {self.topology.gpu_mem_gb:.0f} GB)")
        if need > self.topology.gpus_per_node:
            raise SchedulingError(
                f"job {job.name!r} needs {job.mem_gb:.1f} GB — more than a "
                f"node's total GPU memory "
                f"({self.topology.node_mem_gb:.0f} GB); cross-node lattice "
                f"sharding is not supported (paper: lattices stay within "
                f"one node)")
        if self.policy == "round_robin" and job.shardable:
            # the naive baseline shards everything node-wide
            need = self.topology.gpus_per_node
        return need

    def _pick_pool(self, need: int, chips: List[Chip]) -> List[Chip]:
        if need == 1:
            return [min(chips, key=lambda c: (c.busy_until, c.chip_id))]
        if self.policy == "packed":
            # chip-local: the node whose ``need`` earliest-free chips free
            # up soonest keeps the shards together
            best: Optional[List[Chip]] = None
            best_t = math.inf
            by_node: Dict[int, List[Chip]] = {}
            for c in chips:
                by_node.setdefault(c.node_id, []).append(c)
            for node_chips in by_node.values():
                if len(node_chips) < need:
                    continue
                pool = sorted(node_chips,
                              key=lambda c: (c.busy_until, c.chip_id))[:need]
                t = max(c.busy_until for c in pool)
                if t < best_t:
                    best, best_t = pool, t
            assert best is not None   # need ≤ gpus_per_node is pre-checked
            return best
        # round_robin: stripe across nodes by raw chip order, earliest-free
        return sorted(chips, key=lambda c: (c.busy_until, c.chip_id))[:need]

    def _place(self, job: Job, chips: List[Chip], *,
               op: Optional[OperatingPoint] = None) -> Placement:
        pool = self._pick_pool(self._chips_needed(job), chips)
        return _commit_placement(job, pool, self.penalty, op=op)


# ---------------------------------------------------------------------------
# Online chip pool (the discrete-event simulator's state)
# ---------------------------------------------------------------------------


class ChipPool:
    """Online chip-state tracker for the discrete-event simulator (the JAX
    package's ``cluster/sim.py``; not ported yet).

    The batch :class:`Scheduler` books a whole batch onto
    ``Chip.busy_until`` up front; this pool exposes the *same* chips —
    same selection keys, same tie-breaks as :meth:`Scheduler._pick_pool`
    — to an event loop that acquires chips at dispatch time and releases
    them again on finish/failure/repair events.  A chip's ``busy_until``
    doubles as its "free since" timestamp once idle, so
    earliest-freed-first selection orders by ``(busy_until, chip_id)``
    exactly like the batch scheduler: an all-arrivals-at-t=0, no-failure
    online run reproduces the batch booking bit-for-bit.
    """

    def __init__(self, topology: ClusterTopology, *, policy: str = "packed"):
        if policy not in Scheduler.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"choose from {Scheduler.POLICIES}")
        self.topology = topology
        self.policy = policy
        self.chips = topology.chips()
        self._up = [True] * topology.n_nodes
        self._down_until = [0.0] * topology.n_nodes

    # -- queries -------------------------------------------------------------

    def is_up(self, node_id: int) -> bool:
        return self._up[node_id]

    def node_chips(self, node_id: int) -> List[Chip]:
        g = self.topology.gpus_per_node
        return self.chips[node_id * g:(node_id + 1) * g]

    def _select(self, need: int, chips: List[Chip],
                key) -> Optional[List[Chip]]:
        """The one pool-selection definition (mirrors the batch
        scheduler): single chip → global ``min(key)``; packed shards →
        the node whose ``need`` best chips minimize the max key time
        (nodes visited in id order, strict improvement — first wins
        ties); round_robin → the ``need`` globally-best chips."""
        if need == 1:
            if not chips:
                return None
            return [min(chips, key=key)]
        if self.policy == "packed":
            by_node: Dict[int, List[Chip]] = {}
            for c in chips:
                by_node.setdefault(c.node_id, []).append(c)
            best: Optional[List[Chip]] = None
            best_t = math.inf
            for node_id in sorted(by_node):
                node_chips = by_node[node_id]
                if len(node_chips) < need:
                    continue
                pool = sorted(node_chips, key=key)[:need]
                t = max(key(c)[0] for c in pool)
                if t < best_t:
                    best, best_t = pool, t
            return best
        # round_robin: stripe across nodes by global key order
        if len(chips) < need:
            return None
        return sorted(chips, key=key)[:need]

    def pick_now(self, need: int, t: float,
                 exclude: frozenset = frozenset()) -> Optional[List[Chip]]:
        """A pool of ``need`` chips that are free *right now* (idle, on
        an up node, not in ``exclude``), or None.  ``exclude`` carries a
        blocked queue head's reserved chips during backfill."""
        free = [c for c in self.chips
                if self._up[c.node_id] and c.busy_until <= t
                and c.chip_id not in exclude]
        return self._select(need, free,
                            key=lambda c: (c.busy_until, c.chip_id))

    def earliest_pool(self, need: int,
                      ) -> Tuple[Optional[List[Chip]], float]:
        """Projected reservation for a blocked queue head: the pool of
        ``need`` chips that frees up earliest given current bookings and
        node outages (a down node's chips come back at its repair time).
        Returns ``(chips, t_free)``."""
        def avail(c: Chip) -> float:
            t = c.busy_until
            if not self._up[c.node_id]:
                t = max(t, self._down_until[c.node_id])
            return t

        pool = self._select(need, self.chips,
                            key=lambda c: (avail(c), c.chip_id))
        if pool is None:
            return None, math.inf
        return pool, max(avail(c) for c in pool)

    # -- release hooks (the event loop's state transitions) ------------------

    def release(self, chip_ids: Sequence[int], t: float) -> None:
        """Roll a killed placement's bookings back to ``t`` (node
        failure): the chips become free-since-``t`` immediately."""
        for cid in chip_ids:
            self.chips[cid].busy_until = t

    def fail_node(self, node_id: int, t: float, up_at: float) -> None:
        """Take a node out of service until ``up_at``.  The caller kills
        and :meth:`release`\\ s any placement touching its chips."""
        self._up[node_id] = False
        self._down_until[node_id] = up_at

    def repair_node(self, node_id: int, t: float) -> None:
        """Return a node to service: its chips read as free-since-``t``
        (they could not have been booked while down)."""
        self._up[node_id] = True
        self._down_until[node_id] = 0.0
        for c in self.node_chips(node_id):
            if c.busy_until < t:
                c.busy_until = t


# ---------------------------------------------------------------------------
# Legacy flat API (the pre-Workload call sites of the JAX package)
# ---------------------------------------------------------------------------


def schedule_throughput(jobs: Sequence[Job], chips: List[Chip],
                        *, multi_gpu_penalty: float = MULTI_GPU_SLOWDOWN,
                        ) -> List[Placement]:
    """Greedy list scheduler over an explicit chip list: single-chip
    placement unless the job's memory demands sharding; sharded jobs take
    ceil(mem/chip_mem) chips at synchronous-step pace with the published
    ~20% penalty."""
    placements: List[Placement] = []
    for job in sorted(jobs, key=lambda j: -j.work_units):
        need = max(1, math.ceil(job.mem_gb / chips[0].mem_gb))
        pool = sorted(chips, key=lambda c: (c.busy_until, c.chip_id))[:need]
        placements.append(_commit_placement(job, pool, multi_gpu_penalty))
    return placements


def makespan(placements: Sequence[Placement]) -> float:
    return max(p.end for p in placements) if placements else 0.0


# ---------------------------------------------------------------------------
# Synchronous-step straggler model
# ---------------------------------------------------------------------------

def straggler_step_time(base_step_s: float, perf_scales: Sequence[float],
                        ) -> float:
    """Synchronous SPMD: the slowest participant gates every step."""
    return base_step_s / min(perf_scales)


def expected_slowdown(n_chips: int, sigma: float,
                      rng: Optional[np.random.Generator] = None,
                      trials: int = 256) -> float:
    """E[min perf] over a population with relative spread sigma — how much
    a 1000+ chip job loses to manufacturing spread without mitigation."""
    rng = rng or np.random.default_rng(0)
    mins = rng.normal(1.0, sigma, size=(trials, n_chips)).min(axis=1)
    return float(1.0 / np.clip(mins, 1e-3, None).mean())


def frequency_floor_mitigation(perf_scales: Sequence[float],
                               ) -> Tuple[float, float]:
    """The paper's fix: clock every chip at the slowest chip's sustainable
    rate → no oscillation, flat profile.  Returns (uniform scale, gain vs
    unmitigated oscillating population)."""
    floor = min(perf_scales)
    # oscillating chips lose an extra 8% (throttle.OSC_PENALTY)
    unmitigated = min(p * (1 - 0.08 * (p < 1.0)) for p in perf_scales)
    return floor, floor / unmitigated - 1.0


def drop_slowest_pod(pod_perf: Dict[str, float], threshold: float = 0.93,
                     ) -> Tuple[List[str], float]:
    """Elastic mitigation: drop a pod whose perf is below threshold x median
    if the remaining aggregate throughput improves (synchronous scaling:
    throughput = n_pods x min(perf))."""
    names = list(pod_perf)
    perfs = np.array([pod_perf[n] for n in names])
    full = len(perfs) * perfs.min()
    best_names, best = names, full
    med = float(np.median(perfs))
    for i, n in enumerate(names):
        if perfs[i] < threshold * med:
            rest = np.delete(perfs, i)
            alt = len(rest) * rest.min()
            if alt > best:
                best, best_names = alt, [m for j, m in enumerate(names)
                                         if j != i]
    return best_names, best / full - 1.0


def with_perf_floor(topology: ClusterTopology) -> ClusterTopology:
    """Frequency-floor mitigation applied to a heterogeneous topology:
    every chip paced at the slowest chip's rate (flat-774-style)."""
    if topology.perf_scales is None:
        return topology
    floor = min(topology.perf_scales)
    return replace(topology, perf_scales=(floor,) * topology.n_chips)
