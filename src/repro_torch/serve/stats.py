"""Serve-side statistics: per-request latency percentiles, SLO
compliance, and joules-per-token — all derived from the replay engine's
request records plus the :class:`repro_torch.power.PowerTrace` it emitted
(a copy of the JAX package's ``serve/stats.py``).

Glossary (all times in seconds, all energies in joules):

  * **wait**        admit − arrival (queueing delay before prefill)
  * **TTFT**        first_token − arrival (time to first token: queue +
                    prefill)
  * **latency**     done − arrival (full request turnaround)
  * **J/request**   window energy (busy + idle + host share) / completed
                    requests — idle watts are *charged*, which is the
                    whole autoscaling story
  * **J/token**     window energy / (prompt + generated tokens
                    processed); ``j_per_gen_token`` divides by generated
                    tokens only (the figure the old serve CLI printed,
                    now with an honest denominator)
  * **compliance**  fraction of completed requests with latency ≤ the
                    p99 SLO target (1.0 when no SLO is set)

The engine emits *step* telemetry — doubled samples at each interval
boundary, so the series is piecewise-constant and the trapezoid rule
integrates it exactly.  :func:`step_window_integral` integrates such a
series over an arbitrary window (per-request energy windows land
exactly on interval boundaries, where linear edge interpolation would
split the step); :meth:`PowerTrace.energy_j` with ``(t0, t1)`` remains
the right tool for the smooth dt-gridded cluster traces.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.power.trace import PowerTrace


def step_window_integral(t: np.ndarray, y: np.ndarray,
                         t0: float, t1: float) -> float:
    """∫y dt over [t0, t1] treating ``(t, y)`` as a piecewise-constant
    series: segment ``[t[i], t[i+1])`` carries value ``y[i]`` (its left
    sample).  Exact for the serve engine's doubled-boundary emission,
    including windows whose edges land on boundaries."""
    t = np.asarray(t, dtype=float)
    y = np.asarray(y, dtype=float)
    if t.shape[0] < 2 or t1 <= t0:
        return 0.0
    lo = np.clip(t[:-1], t0, t1)
    hi = np.clip(t[1:], t0, t1)
    return float(np.sum(y[:-1] * np.maximum(hi - lo, 0.0)))


def request_energy_j(trace: PowerTrace, t0: float, t1: float) -> float:
    """This request's share of bus energy over its in-flight window
    [t0, t1]: at every instant it is charged ``power / batch`` where
    ``batch`` is the engine's emitted in-flight count (the ``batch``
    aux series) — computed from the bus, not a side accumulator."""
    b = trace.aux.get("batch")
    if b is None:
        raise ValueError("trace has no 'batch' aux series — not a serve "
                         "replay trace")
    share = trace.power_w / np.maximum(b, 1.0)
    return step_window_integral(trace.t, share, t0, t1)


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


@dataclass(frozen=True)
class ServeStats:
    """One replay's aggregate report (see module glossary)."""

    n_requests: int
    completed: int
    span_s: float
    p50_latency_s: float
    p95_latency_s: float
    p99_latency_s: float
    p50_ttft_s: float
    p99_ttft_s: float
    mean_wait_s: float
    tokens_prompt: int
    tokens_gen: int
    energy_j: float
    peak_power_w: float
    slo_s: Optional[float] = None
    slo_compliance: float = 1.0
    #: replica-failure resilience surface (all 0 without fault injection)
    retries: int = 0                 # failure-driven resubmissions
    gave_up: int = 0                 # requests that exhausted the budget
    replica_failures: int = 0        # live-replica kills during the run

    @property
    def j_per_request(self) -> float:
        return self.energy_j / max(self.completed, 1)

    @property
    def j_per_token(self) -> float:
        return self.energy_j / max(self.tokens_prompt + self.tokens_gen, 1)

    @property
    def j_per_gen_token(self) -> float:
        return self.energy_j / max(self.tokens_gen, 1)

    def summary(self) -> str:
        slo = "" if self.slo_s is None else \
            f" slo<={self.slo_s:.3g}s compliance={self.slo_compliance:.3f}"
        if self.replica_failures or self.retries or self.gave_up:
            slo += (f" | {self.replica_failures} replica failures, "
                    f"{self.retries} retries, {self.gave_up} gave up")
        return (f"{self.completed}/{self.n_requests} req in "
                f"{self.span_s:.3g}s | p50/p99 latency "
                f"{self.p50_latency_s:.3g}/{self.p99_latency_s:.3g}s "
                f"p99 ttft {self.p99_ttft_s:.3g}s{slo} | "
                f"{self.energy_j:.4g} J, {self.j_per_request:.3g} J/req, "
                f"{self.j_per_token:.3g} J/token "
                f"(peak {self.peak_power_w:.0f} W)")


def compute_serve_stats(records, trace: Optional[PowerTrace], *,
                        t0: float = 0.0, span: Optional[float] = None,
                        slo_s: Optional[float] = None,
                        replica_failures: int = 0) -> ServeStats:
    """Fold per-request records + the emitted trace window into one
    :class:`ServeStats`.  ``t0``/``span`` bound the energy integral to
    this replay's own bus emissions (a shared recorder carries earlier
    phases too).

    Under fault injection the compliance denominator *degrades
    honestly*: a request that exhausted its retry budget counts as an
    SLO miss (``ok / (completed + gave_up)``) — identical to the plain
    ratio when nothing was dropped."""
    done = [r for r in records if r.done_s is not None]
    lat = [r.done_s - r.arrival_s for r in done]
    ttft = [r.first_token_s - r.arrival_s for r in done
            if r.first_token_s is not None]
    wait = [r.admit_s - r.arrival_s for r in done if r.admit_s is not None]
    gave_up = sum(1 for r in records if getattr(r, "gave_up", False))
    retries = int(sum(getattr(r, "retries", 0) for r in records))
    energy = 0.0
    peak = 0.0
    if trace is not None:
        t1 = float(trace.t[-1]) if span is None else t0 + span
        energy = trace.energy_j(t0, t1)
        m = (trace.t >= t0) & (trace.t <= t1)
        if np.any(m):
            peak = float(np.max(trace.power_w[m]))
    compliance = 1.0
    if slo_s is not None and (lat or gave_up):
        ok = int(np.sum(np.asarray(lat) <= slo_s)) if lat else 0
        compliance = ok / max(len(lat) + gave_up, 1)
    return ServeStats(
        n_requests=len(records), completed=len(done),
        span_s=(max((r.done_s for r in done), default=0.0)
                - min((r.arrival_s for r in records), default=0.0)),
        p50_latency_s=_pct(lat, 50), p95_latency_s=_pct(lat, 95),
        p99_latency_s=_pct(lat, 99),
        p50_ttft_s=_pct(ttft, 50), p99_ttft_s=_pct(ttft, 99),
        mean_wait_s=float(np.mean(wait)) if wait else 0.0,
        tokens_prompt=int(sum(r.prompt_len for r in done)),
        tokens_gen=int(sum(r.gen_len for r in done)),
        energy_j=energy, peak_power_w=peak,
        slo_s=slo_s, slo_compliance=compliance,
        retries=retries, gave_up=gave_up,
        replica_failures=replica_failures)
