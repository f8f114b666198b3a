"""Recorded-request trace format + seeded synthetic traffic generators
(a copy of the JAX package's ``serve/trace.py``: either package loads
the other's files).

RAPS-style telemetry snapshots (ExaDigiT: ``raps/telemetry.py`` saves
job arrival/shape arrays as npz), applied to *serving*: a request trace
is three parallel arrays —

  * ``arrival_s``    absolute submit time [s]
  * ``prompt_len``   prompt tokens to prefill
  * ``gen_len``      tokens to decode

— saved/loaded as one ``.npz`` with a JSON ``meta`` sidecar key, so a
recorded production stream and a synthetic generator are
interchangeable inputs to the continuous-batching replay engine
(:mod:`repro_torch.serve.engine`).

The generators are seeded and deterministic (the same numpy streams as
the JAX package's):

  * :func:`constant_trace` — fixed-rate (or all-at-t0 burst: the
    analytic-oracle case);
  * :func:`poisson_trace` — exponential inter-arrival gaps, the open
    queue model (mirrors :class:`repro_torch.cluster.events.PoissonArrivals`);
  * :func:`diurnal_trace` — a *non-homogeneous* Poisson process whose
    rate follows a sinusoidal day curve (night trough → midday peak),
    drawn by thinning: the millions-of-users stand-in the autoscaling
    benchmark replays.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence

import numpy as np

_KEYS = ("arrival_s", "prompt_len", "gen_len")


@dataclass
class RequestTrace:
    """One recorded (or synthesized) request stream, sorted by arrival."""

    arrival_s: np.ndarray
    prompt_len: np.ndarray
    gen_len: np.ndarray
    meta: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        a = np.asarray(self.arrival_s, dtype=float)
        p = np.asarray(self.prompt_len)
        g = np.asarray(self.gen_len)
        if not (a.ndim == p.ndim == g.ndim == 1):
            raise ValueError("trace arrays must be 1-D")
        if not (a.shape == p.shape == g.shape):
            raise ValueError(f"trace arrays must share a length, got "
                             f"{a.shape[0]}/{p.shape[0]}/{g.shape[0]}")
        if a.size and (not np.all(np.isfinite(a)) or np.any(a < 0.0)):
            raise ValueError("arrival times must be finite and >= 0")
        for name, arr in (("prompt_len", p), ("gen_len", g)):
            if arr.size and (np.any(arr != np.floor(arr)) or np.any(arr < 1)):
                raise ValueError(f"{name} must be positive integers")
        order = np.argsort(a, kind="stable")
        self.arrival_s = a[order]
        self.prompt_len = p[order].astype(np.int64)
        self.gen_len = g[order].astype(np.int64)

    def __len__(self) -> int:
        return int(self.arrival_s.shape[0])

    @property
    def n_requests(self) -> int:
        return len(self)

    @property
    def duration_s(self) -> float:
        """Arrival span (0 for an empty or single-burst trace)."""
        return float(self.arrival_s[-1] - self.arrival_s[0]) if len(self) \
            else 0.0

    @property
    def total_prompt_tokens(self) -> int:
        return int(self.prompt_len.sum())

    @property
    def total_gen_tokens(self) -> int:
        return int(self.gen_len.sum())

    # -- persistence (RAPS npz snapshot format) ------------------------------

    def save(self, path) -> None:
        np.savez(path, arrival_s=self.arrival_s,
                 prompt_len=self.prompt_len, gen_len=self.gen_len,
                 meta=np.array(json.dumps(self.meta)))

    @classmethod
    def load(cls, path) -> "RequestTrace":
        with np.load(path, allow_pickle=False) as z:
            missing = [k for k in _KEYS if k not in z.files]
            if missing:
                raise ValueError(f"malformed request trace {path!r}: "
                                 f"missing {missing} (has {z.files})")
            meta = {}
            if "meta" in z.files:
                try:
                    meta = json.loads(str(z["meta"]))
                except (json.JSONDecodeError, UnicodeDecodeError) as e:
                    raise ValueError(
                        f"malformed request trace {path!r}: bad meta "
                        f"({e})") from None
            return cls(z["arrival_s"], z["prompt_len"], z["gen_len"],
                       meta=meta)

    # -- sharding ------------------------------------------------------------

    def shard(self, n: int) -> List["RequestTrace"]:
        """Round-robin split into ``n`` shards: each keeps ~1/n of the
        rate with the same arrival-time envelope, so a shard is a
        placeable unit of a cluster-wide stream
        (:class:`repro_torch.serve.replay.ReplayServeWorkload` per shard)."""
        if n < 1:
            raise ValueError("need at least one shard")
        return [RequestTrace(self.arrival_s[i::n], self.prompt_len[i::n],
                             self.gen_len[i::n],
                             meta={**self.meta, "shard": i, "of": n})
                for i in range(n)]


# ---------------------------------------------------------------------------
# Seeded generators
# ---------------------------------------------------------------------------


def _lengths(rng: np.random.Generator, n: int, prompt_lens: Sequence[int],
             gen_lens: Sequence[int]):
    p = rng.choice(np.asarray(prompt_lens, dtype=np.int64), size=n)
    g = rng.choice(np.asarray(gen_lens, dtype=np.int64), size=n)
    return p, g


def constant_trace(n: int, *, prompt_len: int = 64, gen_len: int = 32,
                   rate_per_s: float = 0.0, t0: float = 0.0) -> RequestTrace:
    """``n`` identical requests: all at ``t0`` when ``rate_per_s`` is 0
    (the closed-batch burst the analytic oracle replays), else evenly
    spaced at the given rate."""
    if rate_per_s > 0.0:
        arrival = t0 + np.arange(n) / rate_per_s
    else:
        arrival = np.full(n, float(t0))
    return RequestTrace(arrival, np.full(n, prompt_len),
                        np.full(n, gen_len),
                        meta={"generator": "constant",
                              "rate_per_s": rate_per_s})


def poisson_trace(n: int, rate_per_s: float, *,
                  prompt_lens: Sequence[int] = (64,),
                  gen_lens: Sequence[int] = (32,),
                  seed: int = 0, t0: float = 0.0) -> RequestTrace:
    """Open-queue stream: seeded exponential inter-arrival gaps at
    ``rate_per_s``, prompt/gen lengths drawn from the given discrete
    mixes (discrete buckets keep the engine's prefill-cost cache
    small)."""
    if rate_per_s <= 0.0:
        raise ValueError("rate_per_s must be positive")
    rng = np.random.default_rng(seed)
    arrival = t0 + np.cumsum(rng.exponential(1.0 / rate_per_s, size=n))
    p, g = _lengths(rng, n, prompt_lens, gen_lens)
    return RequestTrace(arrival, p, g,
                        meta={"generator": "poisson", "seed": seed,
                              "rate_per_s": rate_per_s})


def diurnal_trace(duration_s: float, *, rate_peak_per_s: float,
                  rate_floor_per_s: float = 0.0,
                  prompt_lens: Sequence[int] = (64,),
                  gen_lens: Sequence[int] = (32,),
                  seed: int = 0) -> RequestTrace:
    """One synthetic "day" of traffic: a non-homogeneous Poisson
    process whose rate follows a sinusoid — trough ``rate_floor_per_s``
    at t=0 and t=duration, peak ``rate_peak_per_s`` mid-day:

        rate(t) = floor + (peak − floor) · ½(1 − cos 2πt/duration)

    Drawn by thinning a homogeneous process at the peak rate (accept
    with probability rate(t)/peak), so it stays exactly Poisson and
    exactly seeded."""
    if duration_s <= 0.0:
        raise ValueError("duration_s must be positive")
    if rate_peak_per_s <= 0.0 or rate_floor_per_s < 0.0 \
            or rate_floor_per_s > rate_peak_per_s:
        raise ValueError("need 0 <= rate_floor_per_s <= rate_peak_per_s, "
                         "rate_peak_per_s > 0")
    rng = np.random.default_rng(seed)
    arrivals = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_peak_per_s)
        if t >= duration_s:
            break
        rate = rate_floor_per_s + (rate_peak_per_s - rate_floor_per_s) \
            * 0.5 * (1.0 - np.cos(2.0 * np.pi * t / duration_s))
        if rng.uniform() < rate / rate_peak_per_s:
            arrivals.append(t)
    n = len(arrivals)
    p, g = _lengths(rng, n, prompt_lens, gen_lens)
    return RequestTrace(np.asarray(arrivals), p, g,
                        meta={"generator": "diurnal", "seed": seed,
                              "duration_s": duration_s,
                              "rate_peak_per_s": rate_peak_per_s,
                              "rate_floor_per_s": rate_floor_per_s})
