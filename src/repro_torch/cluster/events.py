"""Event model for the online cluster simulator (a copy of the JAX
package's ``cluster/events.py``).

RAPS-style discrete-event operation (ExaDigiT): the simulator's clock
jumps between *events* — job arrivals, job completions, node failures,
node repairs — and between events nothing changes, so the schedule stays
piecewise-constant and the vectorized interval engine evaluates the power
layers once per event boundary instead of once per tick.

This module owns the event vocabulary and the arrival sources:

  * :class:`Arrival` / :func:`batch_arrivals` — explicit ``(t, Job)``
    submissions (all-at-t=0 is the batch-oracle case);
  * :class:`TraceArrivals` — a recorded submission trace, RAPS
    telemetry-replay style;
  * :class:`PoissonArrivals` — seeded exponential inter-arrival times
    over a job list (the open-queue workload model).

Event ordering at one timestamp is fixed by priority: completions free
chips before failures are assessed, failures take nodes down before
repairs bring others back, and arrivals queue last — then the dispatcher
runs once over the drained batch.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.cluster.scheduler import Job

# heap priority at equal timestamps: a job finishing exactly when its
# node fails has completed; a repair lands before a same-instant arrival
# so the arrival sees the node up
FINISH, FAIL, REPAIR, ARRIVE = range(4)


@dataclass(frozen=True)
class Arrival:
    """One submission: the job and its absolute submit time [s].

    ``workload`` (optional) is the ``Workload`` adapter the job
    spec came from — the simulator places/fails/requeues the *job*, and
    can execute the workload at the placement's resolved operating
    point afterwards (``simulate(..., execute=True)``)."""

    t: float
    job: Job
    workload: Optional[Any] = None


def _one(t: float, x) -> Arrival:
    if isinstance(x, Job):
        return Arrival(t, x)
    if hasattr(x, "job") and hasattr(x, "execute"):   # Workload protocol
        return Arrival(t, x.job(), workload=x)
    raise TypeError(f"cannot submit {type(x).__name__!r}: expected a Job "
                    f"or a Workload (has job()/execute())")


def _normalize(items: Iterable) -> List[Arrival]:
    out: List[Arrival] = []
    for it in items:
        if isinstance(it, Arrival):
            out.append(it)
        elif isinstance(it, (Job,)) or (hasattr(it, "job")
                                        and hasattr(it, "execute")):
            out.append(_one(0.0, it))
        else:
            try:
                t, x = it
            except TypeError:
                raise TypeError(
                    f"cannot submit {type(it).__name__!r}: expected an "
                    f"Arrival, a Job, a Workload (has job()/execute()) or "
                    f"a (t, job-or-workload) pair") from None
            out.append(_one(float(t), x))
    if any(a.t < 0.0 for a in out):
        raise ValueError("arrival times must be non-negative")
    # stable: simultaneous submissions keep their submission order
    return sorted(out, key=lambda a: a.t)


def batch_arrivals(jobs: Sequence[Job], t: float = 0.0) -> List[Arrival]:
    """Every job submitted at the same instant — the closed-batch case
    the oracle test compares against ``cluster.run()``."""
    return [Arrival(float(t), j) for j in jobs]


class TraceArrivals:
    """A recorded submission trace: ``(t_submit, Job)`` pairs (or
    :class:`Arrival` objects), replayed verbatim."""

    def __init__(self, items: Iterable):
        self._arrivals = _normalize(items)

    def arrivals(self) -> List[Arrival]:
        return list(self._arrivals)


class PoissonArrivals:
    """Open-queue submissions: the given jobs arrive in order with
    seeded exponential inter-arrival gaps (rate ``rate_per_s``), i.e. a
    Poisson process thinned onto a finite job list.  Deterministic for a
    fixed seed — the property/determinism tests rely on it."""

    def __init__(self, jobs: Sequence[Job], rate_per_s: float, *,
                 seed: int = 0, t0: float = 0.0):
        if rate_per_s <= 0.0:
            raise ValueError("rate_per_s must be positive")
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / rate_per_s, size=len(jobs))
        times = t0 + np.cumsum(gaps)
        self._arrivals = [Arrival(float(t), j) for t, j in zip(times, jobs)]

    def arrivals(self) -> List[Arrival]:
        return list(self._arrivals)


ArrivalsLike = Union[Sequence[Job], Sequence[Arrival], Sequence[Tuple],
                     TraceArrivals, PoissonArrivals]


def as_arrivals(arrivals: ArrivalsLike) -> List[Arrival]:
    """Normalize any supported arrival source to a sorted list: a job
    list (all at t=0), ``(t, job)`` pairs, :class:`Arrival` objects, or
    an arrival-process object with an ``arrivals()`` method."""
    if hasattr(arrivals, "arrivals"):
        return _normalize(arrivals.arrivals())
    return _normalize(arrivals)
