"""Search spaces for the power-aware operating-point autotuner: the JAX
package's ``autotune/space.py``, with the kernel spaces of the port's CUDA
kernels.

The paper's record came from an *offline search* over GPU clock, voltage
ID, fan duty and HPL blocking (§2–4); this module makes that parameter
space a first-class object.  A :class:`Space` is an ordered mapping of
axis name → discrete candidate values; searchers enumerate it (grid) or
walk it one axis at a time (coordinate descent).

Three concrete spaces ship with the port:

  * :func:`operating_space` — the node-level space the paper swept:
    frequency (the S9150's DPM states), voltage ID, fan duty, HPL block
    size and lookahead depth (a copy of the reference's);
  * :func:`dgemm_tile_space` — the CUDA GEMM's block tiles (bm, bn, bk);
  * :func:`dslash_tile_space` — the CUDA D-slash kernels' launch space.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Sequence, Tuple

from repro_torch.kernels.dgemm.kernel import TILES
from repro_torch.power.model import (NB_EFFICIENCY, NB_PERFORMANCE,  # noqa: F401
                                     V_MAX, V_MIN)

# threads per block of both CUDA D-slash kernels, one site each
# (kernels/dslash/csrc/dslash.cu)
DSLASH_THREADS = 128

# The S9150 (Hawaii) exposes a small set of firmware DPM clock states;
# 774 MHz is the one the paper locked for the Green500 run.  The grid is
# the *supported* states, not a continuum — exactly like the real sweep.
S9150_DPM_STATES_MHZ: Tuple[float, ...] = (300.0, 457.0, 562.0, 662.0,
                                           774.0, 851.0, 900.0)


@dataclass(frozen=True)
class Space:
    """An ordered, finite, discrete search space.

    ``axes`` maps axis name → tuple of candidate values.  Iteration order
    is deterministic (itertools.product over the axes in insertion
    order), which makes every searcher reproducible.
    """

    axes: Dict[str, Tuple[Any, ...]] = field(default_factory=dict)

    def __post_init__(self):
        for name, values in self.axes.items():
            if not values:
                raise ValueError(f"axis {name!r} has no candidate values")

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self.axes)

    @property
    def size(self) -> int:
        n = 1
        for values in self.axes.values():
            n *= len(values)
        return n

    def points(self) -> Iterator[Dict[str, Any]]:
        names = self.names
        for combo in itertools.product(*(self.axes[n] for n in names)):
            yield dict(zip(names, combo))

    def first(self) -> Dict[str, Any]:
        return {n: v[0] for n, v in self.axes.items()}

    def with_axis(self, name: str, values: Sequence[Any]) -> "Space":
        axes = dict(self.axes)
        axes[name] = tuple(values)
        return Space(axes)

    def neighbors(self, point: Dict[str, Any], axis: str
                  ) -> Iterator[Dict[str, Any]]:
        """All points differing from ``point`` only along ``axis``."""
        for v in self.axes[axis]:
            yield {**point, axis: v}


def operating_space(*,
                    freqs_mhz: Sequence[float] = S9150_DPM_STATES_MHZ,
                    vids: Sequence[float] = (V_MIN, 1.16, 1.175, V_MAX),
                    fans: Sequence[float] = tuple(
                        round(0.20 + 0.05 * i, 2) for i in range(17)),
                    hpl_blocks: Sequence[int] = (NB_EFFICIENCY,
                                                 NB_PERFORMANCE),
                    lookaheads: Sequence[int] = (1, 2)) -> Space:
    """The paper's node operating-point space (§2–4).

    Fan duty runs 20%…100% in 5% steps (below ~20% the cards overheat
    immediately — the paper never ran there), voltage IDs span the
    published manufacturing range, and blocking is HPL-GPU's
    efficiency/performance NB pair.
    """
    return Space({
        "f_mhz": tuple(float(f) for f in freqs_mhz),
        "vid": tuple(float(v) for v in vids),
        "fan": tuple(float(s) for s in fans),
        "nb": tuple(int(b) for b in hpl_blocks),
        "lookahead": tuple(int(d) for d in lookaheads),
    })


def _tile_candidates(dim: int, choices: Sequence[int]) -> Tuple[int, ...]:
    """Tile sizes from ``choices`` that divide ``dim`` (plus ``dim`` itself
    when it is small enough to be its own tile)."""
    ok = [c for c in choices if c <= dim and dim % c == 0]
    if not ok:
        ok = [dim]
    return tuple(sorted(set(ok)))


def dgemm_tile_space(m: int, k: int, n: int) -> Space:
    """(bm, bn, bk) candidates for an (m, k) @ (k, n) product on the CUDA
    GEMM: its tiles' rows (128, 64), columns (128) and k step (16), each
    kept where it divides its dimension (``ops.dgemm`` checks that, as
    ``matmul_pallas`` asserts) and otherwise replaced by the dimension
    itself.  ``ops.dgemm`` launches the 64-row tile for a ``bm`` below
    128 and the 128-row tile otherwise."""
    return Space({
        "bm": _tile_candidates(m, [t[0] for t in TILES]),
        "bn": _tile_candidates(n, [t[1] for t in TILES]),
        "bk": _tile_candidates(k, [t[2] for t in TILES]),
    })


def dslash_tile_space(lat: Tuple[int, int, int, int]) -> Space:
    """The CUDA D-slash kernels' launch space for lattice ``lat``: one
    point, 128 threads per block.  Both kernels run one thread per site
    over the whole lattice, so the reference's ``t_block`` (T slices per
    sequential grid step, with their halo slices held in VMEM) has no
    counterpart in them, and nothing else of the launch is free."""
    return Space({"threads": (DSLASH_THREADS,)})
