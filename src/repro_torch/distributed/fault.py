"""Fault tolerance for the training loop and node-failure statistics (a
copy of the JAX package's ``distributed/fault.py``; numpy only).

:class:`FaultTolerantLoop` (with :class:`FaultPolicy` and
:class:`StepHealth`) is the training driver's bookkeeping
(:mod:`repro_torch.launch.train`): NaN/inf step detection, the rollback
budget and the per-step wall-time EWMA behind the straggler report.

:class:`WeibullFailureModel` is the per-node MTBF/repair renewal model
the discrete-event cluster simulator (:mod:`repro_torch.cluster.sim`)
draws node outages from, and the serve fleet
(:mod:`repro_torch.serve.autoscale`) its replica kills.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class WeibullFailureModel:
    """Per-node hardware-failure renewal process.

    Uptimes are Weibull-distributed — ``shape < 1`` captures infant
    mortality, ``shape > 1`` wear-out; HPC node-failure traces typically
    fit 0.7–1.8 — with the scale chosen so the *mean* uptime equals
    ``mtbf_s`` (MTBF = scale × Γ(1 + 1/shape)).  Repairs take a fixed
    ``repair_s`` (reboot + health check), after which the next uptime is
    drawn afresh (a renewal process, so no horizon needs to be fixed up
    front — the simulator draws lazily on each repair)."""

    mtbf_s: float = 500.0 * 3600.0     # per-node mean time between failures
    shape: float = 1.3
    repair_s: float = 1800.0

    def __post_init__(self):
        if self.mtbf_s <= 0 or self.shape <= 0 or self.repair_s < 0:
            raise ValueError("mtbf_s and shape must be positive, "
                             "repair_s non-negative")

    @property
    def scale_s(self) -> float:
        """Weibull scale λ with E[uptime] = ``mtbf_s``."""
        return self.mtbf_s / math.gamma(1.0 + 1.0 / self.shape)

    def draw_uptime_s(self, rng: np.random.Generator) -> float:
        """One uptime sample [s] (time from in-service to failure)."""
        return float(self.scale_s * rng.weibull(self.shape))

    def node_streams(self, seed: int,
                     n_nodes: int) -> List[np.random.Generator]:
        """Independent per-node RNG streams (``SeedSequence``-spawned).

        Node ``i``'s uptime sequence depends only on ``(seed, i)`` —
        never on how draws for other nodes interleave — so the
        simulator's lazy per-repair draws and the eager
        :meth:`node_outages` iterator produce *identical* ``(node,
        t_down, t_up)`` sequences from the same seed."""
        ss = np.random.SeedSequence(seed)
        return [np.random.default_rng(child)
                for child in ss.spawn(n_nodes)]

    def node_outages(self, seed, n_nodes: int,
                     horizon_s: float) -> Iterator[Tuple[int, float, float]]:
        """All ``(node, t_down, t_up)`` outages before ``horizon_s`` —
        the eager counterpart of the simulator's lazy per-repair draws
        (planning/analysis use).  ``seed`` is an int (per-node
        :meth:`node_streams`, matching the simulator draw-for-draw) or
        a single shared ``np.random.Generator`` (sequential draws, for
        quick statistics)."""
        if isinstance(seed, np.random.Generator):
            streams = [seed] * n_nodes
        else:
            streams = self.node_streams(int(seed), n_nodes)
        for node in range(n_nodes):
            rng = streams[node]
            t = self.draw_uptime_s(rng)
            while t < horizon_s:
                yield node, t, t + self.repair_s
                t += self.repair_s + self.draw_uptime_s(rng)


@dataclass
class StepHealth:
    step: int
    wall_s: float
    loss: float
    ok: bool
    reason: str = ""


@dataclass
class FaultPolicy:
    max_retries: int = 2
    nan_lr_cut: float = 0.5
    straggler_ewma: float = 0.9
    straggler_threshold: float = 1.25   # x median step time
    checkpoint_every: int = 100


class FaultTolerantLoop:
    """Wraps a step callable with detection/rollback bookkeeping.

    The step fn is pure (params, opt, batch) -> (params, opt, metrics); the
    loop owns the last-good snapshot reference (a checkpoint step id).
    """

    def __init__(self, policy: FaultPolicy = FaultPolicy()):
        self.policy = policy
        self.ewma_wall: Optional[float] = None
        self.history: List[StepHealth] = []
        self.rollbacks = 0

    def observe(self, step: int, wall_s: float, loss: float) -> StepHealth:
        ok = math.isfinite(loss)
        reason = "" if ok else "non-finite loss"
        if self.ewma_wall is None:
            self.ewma_wall = wall_s
        else:
            a = self.policy.straggler_ewma
            self.ewma_wall = a * self.ewma_wall + (1 - a) * wall_s
        h = StepHealth(step, wall_s, loss, ok, reason)
        self.history.append(h)
        return h

    def is_straggling(self, wall_s: float) -> bool:
        return (self.ewma_wall is not None
                and wall_s > self.policy.straggler_threshold * self.ewma_wall)

    def should_rollback(self, h: StepHealth) -> bool:
        if h.ok:
            return False
        self.rollbacks += 1
        return self.rollbacks <= self.policy.max_retries

    def straggler_report(self) -> Dict[str, float]:
        walls = np.asarray([h.wall_s for h in self.history] or [0.0])
        return {
            "median_step_s": float(np.median(walls)),
            "p99_step_s": float(np.percentile(walls, 99)),
            "straggler_ratio": float(np.percentile(walls, 99)
                                     / max(np.median(walls), 1e-9)),
        }
