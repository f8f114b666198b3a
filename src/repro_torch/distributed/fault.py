"""Node-failure statistics (a copy of the JAX package's
``distributed/fault.py``, its failure model).

:class:`WeibullFailureModel` is the per-node MTBF/repair renewal model
the discrete-event cluster simulator (:mod:`repro_torch.cluster.sim`)
draws node outages from, and the serve fleet
(:mod:`repro_torch.serve.autoscale`) its replica kills.  The JAX
module's training-loop helpers (``FaultTolerantLoop``, ``FaultPolicy``,
``StepHealth``) come with the port's train step (ROADMAP A6).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, List, Tuple

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
