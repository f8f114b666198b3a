"""Continuous-batching replay engine over analytic per-step serve costs
(a copy of the JAX package's ``serve/engine.py``, its watts and rates
those of ``chip``, an H100 SXM by default).

The model (vLLM-style continuous batching, reduced to what the paper's
energy question needs):

  * one replica = one chip running the serve model; it holds an
    **in-flight decode batch** of at most ``max_batch`` requests plus a
    FCFS admission queue;
  * admission happens at step boundaries: queued requests join while a
    batch slot and KV-cache budget (``kv_budget_tokens``, reserved as
    ``prompt+gen`` per request, vLLM-reservation style) are free;
  * an admitted group is **prefilled as a batch** (same-prompt-length
    runs grouped); prefill interrupts decode for the whole replica — no
    chunked prefill;
  * decode advances the whole in-flight batch one token per step; steps
    are atomic, and the engine walks step *chunks* cut at the next
    completion or external boundary, so the loop is event-scale, not
    token-scale.

All times and watts come from ``ServeWorkload.energy_plan()``'s
analytic roofline costs (:class:`ServeCostModel`), so a replay is fast,
deterministic and machine-independent: decode steps take the DVFS
plan's ``step_time_s`` and burn ``power_w``; prefill takes the
prefill-shape roofline time; an idle live replica draws the chip idle
floor.  Because decode is memory-bound, a deep clock derate barely
moves ``step_time_s`` but cuts watts — the paper's C5 thesis, measured
here per request.

Telemetry goes onto the :class:`TraceRecorder` bus as *doubled
boundary samples* (piecewise-constant, trapezoid-exact), with the
in-flight count as a ``batch`` aux series — per-request latency and
joules-per-token then fall out of the trace
(:func:`repro_torch.serve.stats.request_energy_j`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.power.model import (H100_SXM, ChipTable, OperatingPoint,
                                     h100_chip_power)
from repro_torch.power.trace import PowerTrace, TraceRecorder
from repro_torch.serve.stats import ServeStats, compute_serve_stats
from repro_torch.serve.trace import RequestTrace

_EPS = 1e-12


class ServeCostModel:
    """Analytic per-step costs for one serve shape, shared by every
    replica: the decode DVFS plan (per operating point) and a prefill
    roofline cache keyed by (prompt_len, group_size).

    Built around :class:`repro_torch.cluster.workload.ServeWorkload` so the
    replay engine, the ``launch.serve`` entry point and the cluster
    scheduler price a step identically.  ``chip`` sets the rates and the
    watts (the JAX class reads its TPU constants)."""

    def __init__(self, arch: str = "llama3-8b", *, max_batch: int = 8,
                 prompt_len: int = 64, gen: int = 32, smoke: bool = True,
                 kv_int8: bool = False, chip: ChipTable = H100_SXM):
        from repro_torch.cluster.workload import ServeWorkload
        self.workload = ServeWorkload(arch=arch, batch=max_batch,
                                      prompt_len=prompt_len, gen=gen,
                                      smoke=smoke, kv_int8=kv_int8,
                                      chip=chip)
        self.chip = chip
        self.arch = arch
        self.max_batch = max_batch
        self.prompt_len = prompt_len
        self.gen = gen
        self.smoke = smoke
        self.kv_int8 = kv_int8
        self._plans: Dict[Tuple[str, Optional[OperatingPoint]], tuple] = {}
        self._prefill: Dict[Tuple[int, int], Tuple[float, float]] = {}

    def plan(self, op: Optional[OperatingPoint] = None,
             mode: str = "efficiency"):
        """(FreqPlan, prefill cost, decode cost) at ``op`` — cached."""
        key = (mode, op)
        if key not in self._plans:
            self._plans[key] = self.workload.energy_plan(mode, op)
        return self._plans[key]

    def prefill_cost(self, prompt_len: int, group: int) \
            -> Tuple[float, float]:
        """(seconds, flops) to prefill a group of ``group`` prompts of
        ``prompt_len`` tokens — the roofline time is clock-independent
        here, exactly as ``ServeWorkload.execute`` bills it."""
        key = (int(prompt_len), int(group))
        hit = self._prefill.get(key)
        if hit is None:
            from repro_torch.config import (SINGLE_POD_MESH, ShapeConfig,
                                            get_arch)
            from repro_torch.roofline.analytic import cost_for
            entry = get_arch(self.arch)
            cfg = entry.smoke() if self.smoke else entry.full()
            pre = cost_for(cfg, ShapeConfig("serve_prefill", int(prompt_len),
                                            int(group), "prefill"),
                           SINGLE_POD_MESH, kv_int8=self.kv_int8,
                           chip=self.chip)
            t = max(pre.compute_s, pre.memory_s) + pre.collective_s
            hit = self._prefill[key] = (t, pre.flops)
        return hit


@dataclass
class RequestRecord:
    """One request's lifecycle timestamps (engine-relative seconds)."""

    idx: int
    arrival_s: float
    prompt_len: int
    gen_len: int
    admit_s: Optional[float] = None        # prefill start (ends queueing)
    first_token_s: Optional[float] = None  # prefill end
    done_s: Optional[float] = None         # last decode step
    replica: int = 0
    tokens: Optional[np.ndarray] = None    # real tokens (executed runtime)
    retries: int = 0                       # replica-failure resubmissions
    gave_up: bool = False                  # retry budget exhausted (dropped)

    @property
    def wait_s(self) -> Optional[float]:
        return None if self.admit_s is None else self.admit_s - self.arrival_s

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.first_token_s is None \
            else self.first_token_s - self.arrival_s

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.done_s is None else self.done_s - self.arrival_s


class Replica:
    """One chip's continuous-batching state machine, advanced between
    external boundaries (arrivals, controller ticks).  Used directly by
    :class:`ContinuousBatchingEngine` (one replica) and by the
    autoscaling fleet (:mod:`repro_torch.serve.autoscale`, N replicas).

    ``live=False`` replicas draw 0 W (powered off); live-but-idle
    replicas draw the chip idle floor."""

    def __init__(self, cost: ServeCostModel, *,
                 op: Optional[OperatingPoint] = None,
                 mode: str = "efficiency",
                 max_batch: Optional[int] = None,
                 kv_budget_tokens: Optional[int] = None,
                 runtime: Optional[Any] = None,
                 rid: int = 0, live: bool = True):
        plan, _pre, dec = cost.plan(op, mode)
        self.cost = cost
        self.plan = plan
        self.t_step = plan.step_time_s
        self.p_busy = plan.power_w
        self.p_idle = h100_chip_power(plan.freq_scale, 0.0, 0.0, cost.chip)
        self.seq_flops = dec.flops / cost.max_batch   # per sequence per step
        self.max_batch = cost.max_batch if max_batch is None else max_batch
        self.kv_budget_tokens = kv_budget_tokens
        self.runtime = runtime
        self.rid = rid
        self.live = live
        self.t = 0.0
        self.queue: List[RequestRecord] = []
        self.inflight: List[List] = []     # [record, tokens_remaining]
        self.kv_used = 0
        # (t_start, t_end, watts, gflops, batch) — contiguous coverage
        self.intervals: List[Tuple[float, float, float, float, int]] = []

    # -- load signals (the autoscaler's observables) -------------------------

    def load(self) -> int:
        return len(self.queue) + len(self.inflight)

    def util(self) -> float:
        return len(self.inflight) / self.max_batch

    # -- submission ----------------------------------------------------------

    def submit(self, rec: RequestRecord) -> None:
        need = rec.prompt_len + rec.gen_len
        if self.kv_budget_tokens is not None and need > self.kv_budget_tokens:
            raise ValueError(
                f"request {rec.idx} needs {need} KV tokens > budget "
                f"{self.kv_budget_tokens} — it could never be admitted")
        rec.replica = self.rid
        self.queue.append(rec)

    # -- internals -----------------------------------------------------------

    def _emit(self, t_end: float, watts: float, gflops: float,
              batch: int) -> None:
        if t_end > self.t + _EPS:
            self.intervals.append((self.t, t_end, watts, gflops, batch))
            self.t = t_end

    def _admit(self) -> List[RequestRecord]:
        admitted: List[RequestRecord] = []
        while self.queue and len(self.inflight) + len(admitted) \
                < self.max_batch:
            rec = self.queue[0]
            need = rec.prompt_len + rec.gen_len
            if self.kv_budget_tokens is not None \
                    and self.kv_used + need > self.kv_budget_tokens:
                break                      # FCFS: no skipping the head
            self.kv_used += need
            admitted.append(self.queue.pop(0))
        return admitted

    def _prefill(self, admitted: List[RequestRecord]) -> None:
        # batch same-prompt-length runs into one prefill each
        i = 0
        while i < len(admitted):
            s = admitted[i].prompt_len
            j = i
            while j < len(admitted) and admitted[j].prompt_len == s:
                j += 1
            group = admitted[i:j]
            t_pre, flops = self.cost.prefill_cost(s, len(group))
            start = self.t
            batch = len(self.inflight) + len(group)
            self._emit(start + t_pre, self.p_busy,
                       flops / max(t_pre, _EPS) / 1e9, batch)
            if self.runtime is not None:
                gen_max = max(r.gen_len for r in group)
                toks = self.runtime.run_group(s, gen_max, len(group))
                for r, row in zip(group, toks):
                    r.tokens = np.asarray(row[:r.gen_len])
            for r in group:
                r.admit_s = start
                r.first_token_s = self.t
                self.inflight.append([r, r.gen_len])
            i = j

    def _decode_chunk(self, t_end: float) -> None:
        rem_min = min(entry[1] for entry in self.inflight)
        k = rem_min
        if t_end != math.inf:
            # cut at the boundary so admissions/control happen on time;
            # steps stay atomic (ceil, at least one)
            k = min(k, max(1, math.ceil((t_end - self.t) / self.t_step
                                        - _EPS)))
        batch = len(self.inflight)
        self._emit(self.t + k * self.t_step, self.p_busy,
                   batch * self.seq_flops / max(self.t_step, _EPS) / 1e9,
                   batch)
        keep: List[List] = []
        for entry in self.inflight:
            entry[1] -= k
            if entry[1] <= 0:
                entry[0].done_s = self.t
                self.kv_used -= entry[0].prompt_len + entry[0].gen_len
            else:
                keep.append(entry)
        self.inflight = keep

    # -- the clock -----------------------------------------------------------

    def advance(self, t_end: float) -> None:
        """Process work until the replica's clock reaches ``t_end``
        (the last busy chunk may overshoot — steps are atomic).  With
        ``t_end=inf``, drain everything submitted and stop."""
        while self.t < t_end - _EPS:
            admitted = self._admit()
            if admitted:
                self._prefill(admitted)
            elif self.inflight:
                self._decode_chunk(t_end)
            elif t_end == math.inf:
                break
            else:
                self._emit(t_end, self.p_idle if self.live else 0.0,
                           0.0, 0)

    def drain(self) -> None:
        self.advance(math.inf)

    # -- failure injection ---------------------------------------------------

    def fail(self) -> List[RequestRecord]:
        """Kill the replica at its current clock: power off and spill
        every queued + in-flight request for the caller to retry
        elsewhere (:mod:`repro_torch.serve.autoscale`).  Generation has no
        durable state, so a spilled request restarts from its prompt —
        admit/first-token stamps are cleared and re-set on the retry
        prefill (the power its dead work burned stays on the trace)."""
        lost = [e[0] for e in self.inflight] + list(self.queue)
        for e in self.inflight:
            e[0].admit_s = None
            e[0].first_token_s = None
        self.inflight = []
        self.queue = []
        self.kv_used = 0
        self.live = False
        return lost


def emit_step_intervals(recorder: TraceRecorder, intervals, *,
                        t_off: float = 0.0,
                        component: str = "chip",
                        components: Optional[Dict[str, np.ndarray]] = None,
                        aux: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Emit contiguous ``(start, end, watts, gflops, batch)`` intervals
    as doubled boundary samples: the series is piecewise-constant and
    the trapezoid integral over any span of whole intervals is exact
    (``emit_intervals``'s dt-grid resampling would smear boundaries).
    ``components`` adds per-interval power series (e.g. host watts);
    ``aux`` adds per-interval aux series (e.g. freq_scale)."""
    if not intervals:
        raise ValueError("no intervals to emit")
    n = len(intervals)
    starts = np.array([iv[0] for iv in intervals]) + t_off
    ends = np.array([iv[1] for iv in intervals]) + t_off
    watts = np.array([iv[2] for iv in intervals])
    gflops = np.array([iv[3] for iv in intervals])
    batch = np.array([float(iv[4]) for iv in intervals])
    if np.any(np.abs(starts[1:] - ends[:-1]) > 1e-9):
        raise ValueError("intervals must be contiguous")
    idx = np.repeat(np.arange(n), 2)
    ts = np.stack([starts, ends], axis=1).reshape(-1)
    comps = {component: watts[idx]}
    if components:
        comps.update({k: np.asarray(v, dtype=float)[idx]
                      for k, v in components.items()})
    extra_aux = {k: np.asarray(v, dtype=float)[idx]
                 for k, v in (aux or {}).items()}
    recorder.emit_series(ts, comps, flops_rate=gflops[idx],
                         batch=batch[idx], **extra_aux)


@dataclass
class ServeResult:
    """One replay: per-request records, the emitted trace, aggregate
    stats, and where on the (possibly shared) bus this replay lives
    (``t_off`` .. ``t_off + span_s``)."""

    records: List[RequestRecord]
    trace: PowerTrace
    stats: ServeStats
    t_off: float
    span_s: float
    plan: Any = field(repr=False, default=None)

    @property
    def energy_j(self) -> float:
        return self.stats.energy_j

    def request_energy_j(self, idx: int) -> float:
        """Request ``idx``'s joules, integrated from the bus over its
        in-flight window at a 1/batch share."""
        from repro_torch.serve.stats import request_energy_j
        r = self.records[idx]
        if r.admit_s is None or r.done_s is None:
            return 0.0
        return request_energy_j(self.trace, self.t_off + r.admit_s,
                                self.t_off + r.done_s)


class ContinuousBatchingEngine:
    """Single-replica replay: feed a :class:`RequestTrace` through one
    continuously-batched chip at an operating point, emitting onto
    ``recorder`` (or a private bus)."""

    def __init__(self, cost: ServeCostModel, *,
                 max_batch: Optional[int] = None,
                 kv_budget_tokens: Optional[int] = None,
                 mode: str = "efficiency",
                 runtime: Optional[Any] = None):
        self.cost = cost
        self.max_batch = max_batch
        self.kv_budget_tokens = kv_budget_tokens
        self.mode = mode
        self.runtime = runtime

    def replay(self, trace: RequestTrace, *,
               op: Optional[OperatingPoint] = None,
               recorder: Optional[TraceRecorder] = None,
               slo_s: Optional[float] = None) -> ServeResult:
        if not len(trace):
            raise ValueError("empty request trace: nothing to replay")
        rep = Replica(self.cost, op=op, mode=self.mode,
                      max_batch=self.max_batch,
                      kv_budget_tokens=self.kv_budget_tokens,
                      runtime=self.runtime)
        records = [RequestRecord(i, float(trace.arrival_s[i]),
                                 int(trace.prompt_len[i]),
                                 int(trace.gen_len[i]))
                   for i in range(len(trace))]
        for rec in records:
            rep.advance(rec.arrival_s)
            rep.submit(rec)
        rep.drain()

        bus = recorder if recorder is not None \
            else TraceRecorder(source="serve.replay")
        t_off = bus.t_last
        emit_step_intervals(bus, rep.intervals, t_off=t_off,
                            aux={"freq_scale": np.full(
                                len(rep.intervals), rep.plan.freq_scale)})
        out = bus.trace()
        span = rep.intervals[-1][1]
        stats = compute_serve_stats(records, out, t0=t_off, span=span,
                                    slo_s=slo_s)
        return ServeResult(records, out, stats, t_off, span, plan=rep.plan)
