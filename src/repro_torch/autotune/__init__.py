"""Power-aware operating-point autotuner (the paper's offline search as
a first-class subsystem): the JAX package's ``repro.autotune`` with cost
models and search spaces of the port's CUDA kernels on an NVIDIA H100.

The Green500 record was found, not configured: the paper swept GPU
clock, voltage ID, fan duty and HPL blocking and took the MFLOPS/W
optimum subject to an acceptable Linpack loss (§2–4).  This package
reproduces that search and generalizes it to the port's kernels:

  * :mod:`repro_torch.autotune.space`   — discrete search spaces
  * :mod:`repro_torch.autotune.search`  — grid + coordinate-descent
    searchers
  * :mod:`repro_torch.autotune.measure` — analytic and measured cost
    models
  * :mod:`repro_torch.autotune.cache`   — JSON cache of winning configs
    keyed by (kernel, shape, device); the ``tuned=True`` paths in
    ``hpl/linpack.py`` and the GEMM op consult it

Quick use::

    from repro_torch.autotune import tune_operating_point
    res = tune_operating_point()          # analytic, < 1 s
    res.best.point   # {'f_mhz': 774.0, 'vid': 1.1425, 'fan': 0.4,
                     #  'nb': 512, 'lookahead': 1}
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch.autotune.cache import (CacheEntry, TuneCache, cache_key,
                                        default_cache, set_default_cache)
from repro_torch.autotune.measure import (AnalyticDgemmModel,
                                          AnalyticDslashModel,
                                          AnalyticHPLBlockingModel,
                                          AnalyticNodeHPLModel,
                                          MeasuredDgemmModel,
                                          MeasuredHPLModel, temp_from_fan)
from repro_torch.autotune.search import (Candidate, TuneResult,
                                         coordinate_descent, grid_search)
from repro_torch.autotune.space import (NB_EFFICIENCY, NB_PERFORMANCE,
                                        S9150_DPM_STATES_MHZ, Space,
                                        dgemm_tile_space, dslash_tile_space,
                                        operating_space)

__all__ = [
    "AnalyticDgemmModel", "AnalyticDslashModel", "AnalyticHPLBlockingModel",
    "AnalyticNodeHPLModel", "CacheEntry", "Candidate", "EFFICIENCY_PERF_LOSS",
    "MeasuredDgemmModel", "MeasuredHPLModel", "NB_EFFICIENCY",
    "NB_PERFORMANCE", "S9150_DPM_STATES_MHZ", "Space", "TuneCache",
    "TuneResult", "cache_key", "coordinate_descent", "default_cache",
    "dgemm_tile_space", "dslash_tile_space", "grid_search",
    "hpl_blocking_space", "operating_space", "set_default_cache",
    "temp_from_fan", "tune_dgemm_tiles", "tune_dslash_tblock",
    "tune_hpl_blocking", "tune_operating_point", "tuned_config",
]

# The paper traded ~13–15% Linpack for the efficiency record (301.5
# TFLOPS at 774 MHz vs the ~6.25 GFLOPS/node performance mode at 900);
# "efficiency mode" accepts up to this much loss.
EFFICIENCY_PERF_LOSS = 0.16


def _search(space: Space, model, *, method: str,
            max_perf_loss: float) -> TuneResult:
    if method == "grid":
        return grid_search(space, model, max_perf_loss=max_perf_loss)
    if method == "coordinate":
        return coordinate_descent(space, model, max_perf_loss=max_perf_loss)
    raise ValueError(f"unknown search method {method!r} "
                     "(expected 'grid' or 'coordinate')")


def tune_operating_point(*, space: Optional[Space] = None,
                         model=None, method: str = "grid",
                         max_perf_loss: float = EFFICIENCY_PERF_LOSS,
                         ) -> TuneResult:
    """Sweep the node operating-point space (clock, voltage ID, fan,
    HPL blocking, lookahead) for the MFLOPS/W optimum under the perf
    floor — the paper's record-setting search, analytic by default."""
    space = space or operating_space()
    model = model or AnalyticNodeHPLModel()
    return _search(space, model, method=method, max_perf_loss=max_perf_loss)


def tune_dgemm_tiles(m: int, k: int, n: int, *, measured: bool = False,
                     method: str = "grid", max_perf_loss: float = 0.10,
                     device="cuda") -> TuneResult:
    """Tile search for the CUDA GEMM (``ops.dgemm``): analytic, or timed
    on ``device`` when ``measured``."""
    space = dgemm_tile_space(m, k, n)
    model = MeasuredDgemmModel(m, k, n, device=device) if measured \
        else AnalyticDgemmModel(m, k, n)
    return _search(space, model, method=method, max_perf_loss=max_perf_loss)


def tune_dslash_tblock(lat: Tuple[int, int, int, int], *,
                       method: str = "grid",
                       max_perf_loss: float = 0.10) -> TuneResult:
    """The reference's T-block search, over the CUDA D-slash kernels'
    launch space: one point, so the result is that launch priced by
    :class:`AnalyticDslashModel` (GFLOP/s at B2's byte bound, and its
    watts).  No op consults it: there is nothing to choose."""
    space = dslash_tile_space(lat)
    model = AnalyticDslashModel(lat)
    return _search(space, model, method=method, max_perf_loss=max_perf_loss)


def hpl_blocking_space(n: int) -> Space:
    """Blocks and lookaheads for an ``n`` × ``n`` ``linpack_run``: the
    power-of-two fractions of ``n`` down to 32, lookahead 1, 0, 2."""
    blocks = []
    b = n // 2
    while b >= 32:
        if n % b == 0:
            blocks.append(b)
        b //= 2
    if not blocks:
        blocks = [n]
    return Space({"block": tuple(blocks), "lookahead": (1, 0, 2)})


def tune_hpl_blocking(n: int, *, measured: bool = False,
                      method: str = "grid",
                      max_perf_loss: float = EFFICIENCY_PERF_LOSS,
                      device="cuda") -> TuneResult:
    """Block-size/lookahead search for an ``n`` × ``n`` ``linpack_run``
    over :func:`hpl_blocking_space`.  The analytic model maps the blocks
    onto the paper's NB axis; the measured model (``measured``, on
    ``device``) times real factorizations."""
    model = MeasuredHPLModel(n, device=device) if measured \
        else AnalyticHPLBlockingModel(n)
    return _search(hpl_blocking_space(n), model, method=method,
                   max_perf_loss=max_perf_loss)


# ---------------------------------------------------------------------------
# The tuned=True consult path
# ---------------------------------------------------------------------------

def _device_name(device="cuda") -> str:
    """The cache's device key for ``device``: the card's name, or
    ``torch-cpu``; never the JAX package's ``cpu`` or ``tpu``, so the two
    packages' entries cannot collide."""
    import torch

    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    if dev.type == "cpu":
        return "torch-cpu"
    raise ValueError(f"the port runs on the card or the CPU, got {dev}")


def tuned_config(kernel: str, shape: Sequence[int], *,
                 device="cuda",
                 cache: Optional[TuneCache] = None,
                 measured: bool = False) -> Dict[str, Any]:
    """Winning config for (kernel, shape, device) — cache hit, or run
    the tuner once and memoize.

    ``device`` is where the kernel runs; the cache keys it by
    :func:`_device_name`, and a measured tuner runs there.
    ``kernel`` is one of ``dgemm`` (shape (m, k, n) → {bm, bn, bk}),
    ``hpl`` (shape (n,) → {block, lookahead}) or ``operating_point``
    (shape () → the full node point).  The CUDA D-slash kernels have no
    launch to tune (:func:`tune_dslash_tblock` prices their one launch),
    so ``dslash`` is not a tunable kernel here."""
    name = _device_name(device)
    if cache is None:                # empty TuneCache is falsy (__len__)
        cache = default_cache()
    shape = tuple(int(d) for d in shape)
    hit = cache.get(kernel, shape, name)
    if hit is not None:
        return dict(hit.config)

    if kernel == "dgemm":
        m, k, n = shape
        res = tune_dgemm_tiles(m, k, n, measured=measured, device=device)
    elif kernel == "hpl":
        (n,) = shape
        res = tune_hpl_blocking(n, measured=measured, device=device)
    elif kernel == "operating_point":
        res = tune_operating_point()
    else:
        raise KeyError(f"unknown tunable kernel {kernel!r}")

    entry = CacheEntry(config=res.as_config(),
                       perf_gflops=res.best.perf_gflops,
                       power_w=res.best.power_w,
                       mflops_per_w=res.best.mflops_per_w,
                       model="measured" if measured else "analytic",
                       perf_loss=res.perf_loss)
    cache.put(kernel, shape, name, entry)
    return dict(entry.config)
