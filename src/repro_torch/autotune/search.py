"""Searchers: exhaustive grid and coordinate descent over a :class:`Space`;
a copy of the JAX package's ``autotune/search.py`` (same iteration order,
tie-breaking and perf floor).

Both maximize MFLOPS/W subject to the paper's *perf-floor* constraint
("efficiency mode"): a point is feasible only if its performance is at
least ``(1 - max_perf_loss)`` of the best performance the model can
reach anywhere in the space.  The returned best point always satisfies
the floor — the floor is anchored at the searcher's own observed peak,
so the peak-performance point itself is always feasible.

A cost model is any callable ``evaluate(point) -> (perf_gflops,
power_w)``.  Returning ``perf <= 0`` (or non-finite values) marks the
point infeasible (e.g. a tile that does not divide its dimension) and it
is skipped.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.autotune.space import Space

Evaluate = Callable[[Dict[str, Any]], Tuple[float, float]]


@dataclass(frozen=True)
class Candidate:
    point: Dict[str, Any]
    perf_gflops: float
    power_w: float

    @property
    def mflops_per_w(self) -> float:
        if self.power_w <= 0:
            return 0.0
        return self.perf_gflops / self.power_w * 1000.0

    @property
    def feasible(self) -> bool:
        return (self.perf_gflops > 0 and self.power_w > 0
                and self.perf_gflops == self.perf_gflops)   # NaN guard


@dataclass
class TuneResult:
    best: Candidate
    peak_perf_gflops: float        # best performance seen anywhere
    perf_floor_gflops: float       # (1 - max_perf_loss) * peak
    max_perf_loss: float
    evaluations: int
    trace: List[Candidate] = field(default_factory=list)

    @property
    def perf_loss(self) -> float:
        """Performance given up vs the peak point (the paper's ~13%)."""
        if self.peak_perf_gflops <= 0:
            return 0.0
        return 1.0 - self.best.perf_gflops / self.peak_perf_gflops

    def as_config(self) -> Dict[str, Any]:
        return dict(self.best.point)


def _evaluate(evaluate: Evaluate, point: Dict[str, Any]) -> Candidate:
    perf, power = evaluate(point)
    return Candidate(dict(point), float(perf), float(power))


def _pick(cands: List[Candidate], floor: float) -> Candidate:
    """Most efficient feasible candidate; ties resolve to the earlier
    (deterministic iteration order)."""
    ok = [c for c in cands if c.feasible and c.perf_gflops >= floor]
    if not ok:       # floor anchored at observed peak -> peak is feasible
        ok = [c for c in cands if c.feasible]
    if not ok:
        raise ValueError("no feasible point in the search space")
    return max(ok, key=lambda c: c.mflops_per_w)


def grid_search(space: Space, evaluate: Evaluate, *,
                max_perf_loss: float = 0.15,
                keep_trace: bool = True) -> TuneResult:
    """Exhaustive sweep — the paper's offline 'heuristic search in the
    parameter space', generalized to any :class:`Space`."""
    cands = [_evaluate(evaluate, p) for p in space.points()]
    feasible = [c for c in cands if c.feasible]
    if not feasible:
        raise ValueError("no feasible point in the search space")
    peak = max(c.perf_gflops for c in feasible)
    floor = (1.0 - max_perf_loss) * peak
    best = _pick(cands, floor)
    return TuneResult(best, peak, floor, max_perf_loss, len(cands),
                      trace=cands if keep_trace else [])


def coordinate_descent(space: Space, evaluate: Evaluate, *,
                       max_perf_loss: float = 0.15,
                       start: Optional[Dict[str, Any]] = None,
                       max_rounds: int = 8) -> TuneResult:
    """Axis-at-a-time search: O(rounds * sum(len(axis))) evaluations
    instead of the grid's product.

    Phase 1 coordinate-*ascends* raw performance to anchor the perf
    floor (the grid search gets this for free from full enumeration);
    phase 2 descends on MFLOPS/W, never accepting a move below the
    floor.  The floor uses the phase-1 peak, so the result can only be
    pessimistic about feasibility, never violate it.
    """
    trace: List[Candidate] = []
    evals = 0

    def counted(p: Dict[str, Any]) -> Candidate:
        nonlocal evals
        c = _evaluate(evaluate, p)
        evals += 1
        trace.append(c)
        return c

    def sweep_axis(point: Dict[str, Any], axis: str,
                   key: Callable[[Candidate], float],
                   floor: float) -> Candidate:
        cands = []
        for p in space.neighbors(point, axis):
            c = counted(p)
            if c.feasible and c.perf_gflops >= floor:
                cands.append(c)
        if not cands:
            return counted(point)
        return max(cands, key=key)

    def descend(start_pt: Dict[str, Any],
                key: Callable[[Candidate], float],
                floor: float) -> Candidate:
        cur = counted(start_pt)
        for _ in range(max_rounds):
            moved = False
            for axis in space.names:
                nxt = sweep_axis(cur.point, axis, key, floor)
                if key(nxt) > key(cur) + 1e-12:
                    cur, moved = nxt, True
            if not moved:
                break
        return cur

    start = dict(start or space.first())
    # Phase 1: find the performance peak (anchors the floor).
    peak_cand = descend(start, lambda c: c.perf_gflops, floor=0.0)
    peak = peak_cand.perf_gflops
    floor = (1.0 - max_perf_loss) * peak
    # Phase 2: maximize efficiency subject to the floor, starting from
    # the peak point (which satisfies the floor by construction).
    best = descend(peak_cand.point, lambda c: c.mflops_per_w, floor=floor)
    if best.perf_gflops < floor:          # defensive: never violate
        best = peak_cand
    return TuneResult(best, peak, floor, max_perf_loss, evals, trace=trace)
