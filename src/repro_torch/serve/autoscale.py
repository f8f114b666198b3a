"""SLO-aware autoscaling + operating-point policy over a replica fleet
(a copy of the JAX package's ``serve/autoscale.py``).

The headline question (ROADMAP: "what operating point + autoscaling
policy minimizes energy per request under a p99 latency SLO and a wall
power cap?") becomes a closed-loop simulation:

  * a fleet of up to ``n_max`` :class:`~repro_torch.serve.engine.Replica`
    chips, each running the same serve model at the policy's DVFS
    operating point (per-replica ``OperatingPoint``);
  * a **router** that assigns each arriving request to the
    least-loaded live replica (LB tie-break: lowest id, so high-id
    replicas drain naturally and can be parked);
  * a **controller** ticking every ``dt_ctrl_s``: scale **up** when
    total backlog exceeds ``up_backlog ×`` the live slot capacity for
    ``hold_up`` consecutive ticks, scale **down** when in-flight
    utilization stays under ``down_util`` for ``hold_down`` ticks —
    classic queue-depth hysteresis.  Parked replicas draw 0 W; a
    replica being woken draws idle power for ``startup_s`` before it
    accepts traffic (model load), which is what makes hysteresis
    matter;
  * a **wall power cap**: the live-replica count is bounded so that
    worst-case draw (busy chips + host share) never exceeds
    ``power_cap_w`` — the cap is enforced by construction and verified
    against the emitted trace's peak.

Each live replica is charged a host-power share
(``P_HOST_DC_W / 4`` — one L-CSC host board serves 4 accelerators), so
"static flat-out" pays idle chip + host watts all night while the
autoscaled fleet parks replicas through the diurnal trough: that gap,
at equal SLO compliance, is what the policy comparison measures.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from itertools import count
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.distributed.fault import WeibullFailureModel
from repro_torch.power.layers import P_HOST_DC_W
from repro_torch.power.model import OperatingPoint
from repro_torch.power.trace import PowerTrace, TraceRecorder
from repro_torch.serve.engine import (Replica, RequestRecord, ServeCostModel,
                                emit_step_intervals)
from repro_torch.serve.stats import ServeStats, compute_serve_stats
from repro_torch.serve.trace import RequestTrace

#: per-replica share of the node host board (4 accelerators per host)
HOST_SHARE_W = P_HOST_DC_W / 4.0


@dataclass(frozen=True)
class RetryPolicy:
    """How spilled requests are retried after a replica failure: capped
    exponential backoff (``backoff_s · 2^(attempt-1)``, clipped at
    ``backoff_cap_s``) onto the surviving replicas, against a per-request
    ``max_retries`` budget — exhausting it marks the request
    ``gave_up`` (an honest SLO miss in :class:`ServeStats`)."""

    max_retries: int = 3
    backoff_s: float = 0.5
    backoff_cap_s: float = 8.0

    def __post_init__(self):
        if self.max_retries < 0 or self.backoff_s <= 0.0 \
                or self.backoff_cap_s < self.backoff_s:
            raise ValueError("max_retries must be ≥ 0, backoff_s positive "
                             "and backoff_cap_s ≥ backoff_s")

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        return min(self.backoff_s * 2.0 ** (max(attempt, 1) - 1),
                   self.backoff_cap_s)


@dataclass(frozen=True)
class AutoscalePolicy:
    """One point in the policy space the benchmark compares."""

    name: str = "autoscaled"
    n_max: int = 8
    n_min: int = 1
    op: Optional[OperatingPoint] = None   # per-replica DVFS point
    mode: str = "efficiency"              # DVFS plan mode
    autoscale: bool = True                # False: n_max live forever
    dt_ctrl_s: float = 10.0
    startup_s: float = 0.0                # wake latency (idle W, no traffic)
    up_backlog: float = 1.25              # backlog / live slots to scale up
    down_util: float = 0.30               # in-flight util to scale down
    hold_up: int = 1                      # consecutive ticks (hysteresis)
    hold_down: int = 3
    power_cap_w: Optional[float] = None


def flat_out(n: int, *, name: str = "static_flat_out",
             power_cap_w: Optional[float] = None) -> AutoscalePolicy:
    """The baseline: every replica live for the whole day at the stock
    clock in performance mode — no DVFS derate, no parking."""
    return AutoscalePolicy(name=name, n_max=n, n_min=n,
                           op=OperatingPoint(f_mhz=900.0),
                           mode="performance", autoscale=False,
                           power_cap_w=power_cap_w)


@dataclass
class FleetResult:
    """One policy's day: per-request records, the merged fleet trace
    (chip + host components), aggregate stats, and the live-replica
    step series the controller produced."""

    policy: AutoscalePolicy
    records: List[RequestRecord]
    trace: PowerTrace
    stats: ServeStats
    live_t: np.ndarray          # live-count step series (times)
    live_n: np.ndarray
    t_off: float
    span_s: float
    busy_w_per_replica: float = 0.0
    replica_failures: int = 0
    # every (rid, t_down, t_up) injected during the run
    outages: List[Tuple[int, float, float]] = field(default_factory=list)

    @property
    def n_live_peak(self) -> int:
        return int(self.live_n.max()) if self.live_n.size else 0

    @property
    def n_live_min(self) -> int:
        return int(self.live_n.min()) if self.live_n.size else 0


def _merge_fleet(replicas: List[Replica], live_t: np.ndarray,
                 live_n: np.ndarray):
    """Sum the replicas' piecewise-constant intervals (plus the host
    share of the live count) onto the union of their boundaries."""
    edges = set()
    for r in replicas:
        for iv in r.intervals:
            edges.add(iv[0])
            edges.add(iv[1])
    edges.update(float(t) for t in live_t)
    edges = np.array(sorted(edges))
    mids = 0.5 * (edges[:-1] + edges[1:])
    chip = np.zeros(mids.shape)
    gflops = np.zeros(mids.shape)
    batch = np.zeros(mids.shape)
    for r in replicas:
        starts = np.array([iv[0] for iv in r.intervals])
        ends = np.array([iv[1] for iv in r.intervals])
        pos = np.searchsorted(starts, mids, side="right") - 1
        ok = pos >= 0
        p = np.clip(pos, 0, len(starts) - 1)
        ok &= mids < ends[p]
        chip[ok] += np.array([iv[2] for iv in r.intervals])[p[ok]]
        gflops[ok] += np.array([iv[3] for iv in r.intervals])[p[ok]]
        batch[ok] += np.array([float(iv[4]) for iv in r.intervals])[p[ok]]
    lp = np.clip(np.searchsorted(live_t, mids, side="right") - 1,
                 0, len(live_t) - 1)
    host = live_n[lp] * HOST_SHARE_W
    intervals = [(float(edges[i]), float(edges[i + 1]), float(chip[i]),
                  float(gflops[i]), int(batch[i]))
                 for i in range(len(mids))]
    return intervals, host


def run_fleet(cost: ServeCostModel, requests: RequestTrace,
              policy: AutoscalePolicy, *,
              slo_s: Optional[float] = None,
              recorder: Optional[TraceRecorder] = None,
              failures: Optional[WeibullFailureModel] = None,
              retry: Optional[RetryPolicy] = None,
              failure_seed: int = 0) -> FleetResult:
    """Replay ``requests`` through a fleet under ``policy`` and return
    the merged telemetry + stats (see module docstring).

    ``failures`` injects per-replica Weibull kills (seeded by
    ``failure_seed``, one RNG stream per slot): a dead replica spills
    its queued + in-flight requests, which are retried under ``retry``
    (default :class:`RetryPolicy`) with capped exponential backoff onto
    the survivors; the slot returns after ``repair_s``.  Without
    ``failures`` the original event loop runs unchanged (bit-identical
    baseline)."""
    if not len(requests):
        raise ValueError("empty request trace: nothing to serve")
    if failures is not None:
        return _run_fleet_failures(cost, requests, policy, slo_s=slo_s,
                                   recorder=recorder, failures=failures,
                                   retry=retry or RetryPolicy(),
                                   failure_seed=failure_seed)
    probe = Replica(cost, op=policy.op, mode=policy.mode)
    worst_w = probe.p_busy + HOST_SHARE_W
    n_eff = policy.n_max
    if policy.power_cap_w is not None:
        n_allowed = int(math.floor(policy.power_cap_w / worst_w + 1e-9))
        if n_allowed < policy.n_min:
            raise ValueError(
                f"power cap {policy.power_cap_w:.0f} W admits only "
                f"{n_allowed} replicas at {worst_w:.0f} W each < n_min="
                f"{policy.n_min}")
        n_eff = min(n_eff, n_allowed)

    replicas = [Replica(cost, op=policy.op, mode=policy.mode, rid=i,
                        live=False)
                for i in range(policy.n_max)]
    n_init = policy.n_min if policy.autoscale else n_eff
    available_at = [math.inf] * policy.n_max
    for i in range(n_init):
        replicas[i].live = True
        available_at[i] = 0.0
    live_events: List[Tuple[float, int]] = [(0.0, n_init)]

    records = [RequestRecord(i, float(requests.arrival_s[i]),
                             int(requests.prompt_len[i]),
                             int(requests.gen_len[i]))
               for i in range(len(requests))]

    def advance_all(t: float) -> None:
        for r in replicas:
            if r.t < t:
                r.advance(t)

    def route(rec: RequestRecord, t: float) -> None:
        live = [r for r in replicas if r.live]
        ready = [r for r in live if available_at[r.rid] <= t]
        pool = ready or live
        target = min(pool, key=lambda r: (r.load(), r.rid))
        target.submit(rec)

    up_count = down_count = 0

    def control(t: float) -> None:
        nonlocal up_count, down_count
        if not policy.autoscale:
            return
        live = [r for r in replicas if r.live]
        n_live = len(live)
        slots = n_live * replicas[0].max_batch
        backlog = sum(r.load() for r in live)
        util = sum(len(r.inflight) for r in live) / max(slots, 1)
        if backlog > policy.up_backlog * slots:
            up_count += 1
            down_count = 0
        elif util < policy.down_util:
            down_count += 1
            up_count = 0
        else:
            up_count = down_count = 0
        if up_count >= policy.hold_up and n_live < n_eff:
            r_on = next(r for r in replicas if not r.live)
            r_on.live = True
            available_at[r_on.rid] = t + policy.startup_s
            live_events.append((t, n_live + 1))
            up_count = 0
        elif down_count >= policy.hold_down and n_live > policy.n_min:
            idle = [r for r in live if r.load() == 0
                    and available_at[r.rid] <= t]
            if idle:
                r_off = max(idle, key=lambda r: r.rid)
                r_off.live = False
                available_at[r_off.rid] = math.inf
                live_events.append((t, n_live - 1))
                down_count = 0

    i = 0
    n = len(records)
    t_tick = policy.dt_ctrl_s
    while i < n:
        t_arr = records[i].arrival_s
        if t_arr <= t_tick:
            advance_all(t_arr)
            route(records[i], t_arr)
            i += 1
        else:
            advance_all(t_tick)
            control(t_tick)
            t_tick += policy.dt_ctrl_s

    # traffic over: drain in place (no further control), then bring every
    # replica to the common horizon — the last work completion — so both
    # policies are billed over the same kind of span, with no idle tail
    # quantized to the control tick
    for r in replicas:
        r.drain()
    horizon = max(r.t for r in replicas)
    for r in replicas:
        if r.t < horizon:
            r.advance(horizon)

    live_t = np.array([e[0] for e in live_events])
    live_n = np.array([float(e[1]) for e in live_events])
    intervals, host = _merge_fleet(replicas, live_t, live_n)
    bus = recorder if recorder is not None \
        else TraceRecorder(source=f"serve.fleet.{policy.name}")
    t_off = bus.t_last
    emit_step_intervals(bus, intervals, t_off=t_off,
                        components={"host": host},
                        aux={"n_live": live_n[np.clip(
                            np.searchsorted(live_t, np.array(
                                [0.5 * (iv[0] + iv[1])
                                 for iv in intervals]), side="right") - 1,
                            0, len(live_t) - 1)]})
    trace = bus.trace()
    span = intervals[-1][1]
    stats = compute_serve_stats(records, trace, t0=t_off, span=span,
                                slo_s=slo_s)
    if policy.power_cap_w is not None \
            and stats.peak_power_w > policy.power_cap_w + 1e-6:
        raise AssertionError(
            f"policy {policy.name!r} exceeded its own power cap: "
            f"{stats.peak_power_w:.1f} W > {policy.power_cap_w:.1f} W")
    return FleetResult(policy, records, trace, stats, live_t, live_n,
                       t_off, span, busy_w_per_replica=probe.p_busy)


# event priorities at equal timestamps: repairs land before the failure
# clock restarts, retries/arrivals see post-repair capacity, controller
# ticks observe the settled state (arrival-before-tick matches the
# no-failure loop's ``t_arr <= t_tick`` ordering)
_PRIO = {"repair": 0, "fail": 1, "retry": 2, "arrive": 3, "tick": 4}


def _run_fleet_failures(cost: ServeCostModel, requests: RequestTrace,
                        policy: AutoscalePolicy, *,
                        slo_s: Optional[float],
                        recorder: Optional[TraceRecorder],
                        failures: WeibullFailureModel,
                        retry: RetryPolicy,
                        failure_seed: int) -> FleetResult:
    """The fault-injected twin of :func:`run_fleet`'s event loop:
    arrivals, controller ticks, per-slot Weibull kills, repairs and
    retry wake-ups merged on one event heap."""
    probe = Replica(cost, op=policy.op, mode=policy.mode)
    worst_w = probe.p_busy + HOST_SHARE_W
    n_eff = policy.n_max
    if policy.power_cap_w is not None:
        n_allowed = int(math.floor(policy.power_cap_w / worst_w + 1e-9))
        if n_allowed < policy.n_min:
            raise ValueError(
                f"power cap {policy.power_cap_w:.0f} W admits only "
                f"{n_allowed} replicas at {worst_w:.0f} W each < n_min="
                f"{policy.n_min}")
        n_eff = min(n_eff, n_allowed)

    replicas = [Replica(cost, op=policy.op, mode=policy.mode, rid=i,
                        live=False)
                for i in range(policy.n_max)]
    n_init = policy.n_min if policy.autoscale else n_eff
    available_at = [math.inf] * policy.n_max
    for i in range(n_init):
        replicas[i].live = True
        available_at[i] = 0.0
    live_events: List[Tuple[float, int]] = [(0.0, n_init)]

    records = [RequestRecord(i, float(requests.arrival_s[i]),
                             int(requests.prompt_len[i]),
                             int(requests.gen_len[i]))
               for i in range(len(requests))]

    rngs = failures.node_streams(failure_seed, policy.n_max)
    down_until = [0.0] * policy.n_max
    revive = [False] * policy.n_max   # was live when killed → relive
    outages: List[Tuple[int, float, float]] = []
    replica_failures = 0
    arrivals_left = len(records)
    retries_pending = 0

    heap: List[tuple] = []
    seq = count()

    def push(t: float, kind: str, payload=None) -> None:
        heapq.heappush(heap, (t, _PRIO[kind], next(seq), kind, payload))

    for rec in records:
        push(rec.arrival_s, "arrive", rec)
    for rid in range(policy.n_max):
        push(failures.draw_uptime_s(rngs[rid]), "fail", rid)
    push(policy.dt_ctrl_s, "tick", None)

    def advance_all(t: float) -> None:
        for r in replicas:
            if r.t < t:
                r.advance(t)

    def n_live() -> int:
        return sum(1 for r in replicas if r.live)

    def route(rec: RequestRecord, t: float) -> bool:
        live = [r for r in replicas if r.live]
        if not live:
            return False
        ready = [r for r in live if available_at[r.rid] <= t]
        pool = ready or live
        target = min(pool, key=lambda r: (r.load(), r.rid))
        target.submit(rec)
        return True

    def wake_spare(t: float) -> None:
        """Emergency replacement: bring up the lowest-id parked,
        repaired slot (capacity lost to a kill comes back before the
        controller would react)."""
        if n_live() >= n_eff:
            return
        spare = [r for r in replicas
                 if not r.live and down_until[r.rid] <= t]
        if spare:
            r_on = min(spare, key=lambda r: r.rid)
            r_on.live = True
            available_at[r_on.rid] = t + policy.startup_s
            live_events.append((t, n_live()))

    def submit_or_park(rec: RequestRecord, t: float) -> None:
        """Route now, or — with every slot dead — park on the retry
        heap (no budget consumed: the outage is the fleet's fault)."""
        nonlocal retries_pending
        if not route(rec, t):
            wake_spare(t)
            if not route(rec, t):
                retries_pending += 1
                push(t + retry.backoff_s, "retry", rec)

    up_count = down_count = 0

    def control(t: float) -> None:
        nonlocal up_count, down_count
        if not policy.autoscale:
            return
        live = [r for r in replicas if r.live]
        n_now = len(live)
        slots = n_now * replicas[0].max_batch
        backlog = sum(r.load() for r in live)
        util = sum(len(r.inflight) for r in live) / max(slots, 1)
        if backlog > policy.up_backlog * slots:
            up_count += 1
            down_count = 0
        elif util < policy.down_util:
            down_count += 1
            up_count = 0
        else:
            up_count = down_count = 0
        if up_count >= policy.hold_up and n_now < n_eff:
            spare = [r for r in replicas
                     if not r.live and down_until[r.rid] <= t]
            if spare:
                r_on = min(spare, key=lambda r: r.rid)
                r_on.live = True
                available_at[r_on.rid] = t + policy.startup_s
                live_events.append((t, n_now + 1))
                up_count = 0
        elif down_count >= policy.hold_down and n_now > policy.n_min:
            idle = [r for r in live if r.load() == 0
                    and available_at[r.rid] <= t]
            if idle:
                r_off = max(idle, key=lambda r: r.rid)
                r_off.live = False
                available_at[r_off.rid] = math.inf
                live_events.append((t, n_now - 1))
                down_count = 0

    while heap:
        t, _, _, kind, payload = heapq.heappop(heap)
        if kind == "repair":
            rid = payload
            if revive[rid] and n_live() < n_eff:
                r_on = replicas[rid]
                r_on.live = True
                available_at[rid] = t + policy.startup_s
                live_events.append((t, n_live()))
            revive[rid] = False
            # the slot's failure clock restarts when it is back in
            # service — a renewal process per slot, like the cluster sim
            push(t + failures.draw_uptime_s(rngs[rid]), "fail", rid)
        elif kind == "fail":
            rid = payload
            advance_all(t)
            down_until[rid] = t + failures.repair_s
            outages.append((rid, t, down_until[rid]))
            push(down_until[rid], "repair", rid)
            r = replicas[rid]
            if r.live:
                replica_failures += 1
                lost = r.fail()
                revive[rid] = True
                available_at[rid] = math.inf
                live_events.append((t, n_live()))
                if n_live() < policy.n_min:
                    wake_spare(t)
                for rec in lost:
                    rec.retries += 1
                    if rec.retries > retry.max_retries:
                        rec.gave_up = True
                    else:
                        retries_pending += 1
                        push(t + retry.delay_s(rec.retries), "retry", rec)
        elif kind == "retry":
            retries_pending -= 1
            advance_all(t)
            submit_or_park(payload, t)
        elif kind == "arrive":
            arrivals_left -= 1
            advance_all(t)
            submit_or_park(payload, t)
        else:                                        # tick
            advance_all(t)
            control(t)
            if (arrivals_left or retries_pending
                    or any(r.load() for r in replicas)):
                push(t + policy.dt_ctrl_s, "tick", None)
        if (not arrivals_left and not retries_pending
                and not any(r.load() for r in replicas)):
            break

    for r in replicas:
        r.drain()
    horizon = max(r.t for r in replicas)
    for r in replicas:
        if r.t < horizon:
            r.advance(horizon)

    live_t = np.array([e[0] for e in live_events])
    live_n = np.array([float(e[1]) for e in live_events])
    intervals, host = _merge_fleet(replicas, live_t, live_n)
    bus = recorder if recorder is not None \
        else TraceRecorder(source=f"serve.fleet.{policy.name}")
    t_off = bus.t_last
    emit_step_intervals(bus, intervals, t_off=t_off,
                        components={"host": host},
                        aux={"n_live": live_n[np.clip(
                            np.searchsorted(live_t, np.array(
                                [0.5 * (iv[0] + iv[1])
                                 for iv in intervals]), side="right") - 1,
                            0, len(live_t) - 1)]})
    trace = bus.trace()
    span = intervals[-1][1]
    stats = compute_serve_stats(records, trace, t0=t_off, span=span,
                                slo_s=slo_s,
                                replica_failures=replica_failures)
    if policy.power_cap_w is not None \
            and stats.peak_power_w > policy.power_cap_w + 1e-6:
        raise AssertionError(
            f"policy {policy.name!r} exceeded its own power cap: "
            f"{stats.peak_power_w:.1f} W > {policy.power_cap_w:.1f} W")
    return FleetResult(policy, records, trace, stats, live_t, live_n,
                       t_off, span, busy_w_per_replica=probe.p_busy,
                       replica_failures=replica_failures, outages=outages)
