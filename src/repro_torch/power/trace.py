"""Time-stepped power telemetry: the ``PowerTrace`` type and the
``TraceRecorder`` event bus (a copy of the JAX package's
``power/trace.py``; numpy only).

RAPS-style design (ExaDigiT): one fixed-interval, per-component power
time series that every workload emits into and every consumer (Green500
methodology, paper-table benchmarks, launch drivers) reads from.  The
trace is a struct-of-arrays:

  * ``t``           sample times [s]
  * ``components``  component name → watts array (``gpu``, ``host``,
                    ``fan``, ``psu_loss``, ``network``, ``chip_*`` …)
  * ``flops_rate``  instantaneous GFLOPS (for efficiency figures)
  * ``aux``         optional extra series (utilization, clocks [MHz],
                    temperature [°C], …)

Compute power (``power_w``) excludes the ``network`` component — the
Green500 methodology treats switches separately per measurement level.

Storage is columnar (struct-of-arrays, the RAPS idiom): scalar ``emit``
calls append to per-series Python lists, bulk ``emit_series`` calls seal
whole numpy chunks, and ``trace()`` concatenates — no per-sample dict
rows, so the vectorized cluster engine can land a 160-node run in a
handful of array appends.  ``t_last`` is a running maximum (O(1)) and
``trace()`` only sorts when emissions actually arrived out of order.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

# numpy >= 2.0 spells it ``trapezoid``; 1.x only ``trapz``
_np_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def trapezoid(y, x=None, dx: float = 1.0, axis: int = -1):
    """Trapezoidal integration on either numpy line (1.22+ and 2.x)."""
    return _np_trapezoid(y, x=x, dx=dx, axis=axis)


NETWORK = "network"


@dataclass
class PowerTrace:
    """Fixed- or variable-interval per-component power time series."""

    t: np.ndarray
    components: Dict[str, np.ndarray]
    flops_rate: np.ndarray
    aux: Dict[str, np.ndarray] = field(default_factory=dict)
    meta: Dict[str, Any] = field(default_factory=dict)
    # traces are effectively immutable post-construction, so the component
    # sum is computed once (the Green500 L1/L2/L3 window scans hit
    # ``power_w`` per call) — never invalidated
    _power_w_cache: Optional[np.ndarray] = field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.t = np.asarray(self.t, dtype=float)
        n = self.t.shape[0]
        self.components = {k: np.broadcast_to(
            np.asarray(v, dtype=float), (n,)).copy()
            for k, v in self.components.items()}
        self.flops_rate = np.broadcast_to(
            np.asarray(self.flops_rate, dtype=float), (n,)).copy()
        self.aux = {k: np.asarray(v, dtype=float) for k, v in self.aux.items()}

    # -- construction -------------------------------------------------------

    @classmethod
    def from_arrays(cls, t, power_w, flops_rate, *, network_w: float = 0.0,
                    component: str = "node", **meta) -> "PowerTrace":
        """Single-component trace (the legacy ``LinpackTrace`` shape)."""
        t = np.asarray(t, dtype=float)
        comps = {component: np.asarray(power_w, dtype=float)}
        if network_w:
            comps[NETWORK] = np.full(t.shape, float(network_w))
        return cls(t, comps, np.asarray(flops_rate, dtype=float), meta=meta)

    # -- views --------------------------------------------------------------

    @property
    def power_w(self) -> np.ndarray:
        """Compute-subsystem wall power (all components except network).
        Cached on first access (traces are immutable by convention)."""
        if self._power_w_cache is None:
            out = np.zeros_like(self.t)
            for name, w in self.components.items():
                if name != NETWORK:
                    out = out + w
            self._power_w_cache = out
        return self._power_w_cache

    @property
    def network_w(self) -> float:
        """Average switch power (0 when the trace has no network data)."""
        w = self.components.get(NETWORK)
        return float(np.mean(w)) if w is not None and len(w) else 0.0

    @property
    def duration(self) -> float:
        return float(self.t[-1] - self.t[0])

    def total_flops(self, t0: Optional[float] = None,
                    t1: Optional[float] = None) -> float:
        """∫flops_rate dt — over [t0, t1] when given, else the whole
        trace (the flops counterpart of :meth:`energy_j`)."""
        if t0 is None and t1 is None:
            return float(trapezoid(self.flops_rate, self.t))
        t0 = float(self.t[0]) if t0 is None else t0
        t1 = float(self.t[-1]) if t1 is None else t1
        return self._window_integral(self.flops_rate, t0, t1)

    def _window_integral(self, y: np.ndarray, t0: float, t1: float) -> float:
        """∫y dt over [t0, t1], linearly interpolating at the window edges
        (windows need not land on sample times)."""
        m = (self.t > t0) & (self.t < t1)
        ts = np.concatenate(([t0], self.t[m], [t1]))
        ys = np.concatenate(([np.interp(t0, self.t, y)], y[m],
                             [np.interp(t1, self.t, y)]))
        return float(trapezoid(ys, ts))

    def avg_power(self, t0: Optional[float] = None,
                  t1: Optional[float] = None,
                  include_network: bool = True) -> float:
        """Time-averaged power over [t0, t1] (defaults: the full trace)."""
        t0 = float(self.t[0]) if t0 is None else t0
        t1 = float(self.t[-1]) if t1 is None else t1
        if t1 <= t0:
            raise ValueError(f"empty averaging window [{t0}, {t1}]")
        p = self._window_integral(self.power_w, t0, t1) / (t1 - t0)
        net = self.components.get(NETWORK)
        if include_network and net is not None:
            p += self._window_integral(net, t0, t1) / (t1 - t0)
        return p

    def energy_j(self, t0: Optional[float] = None,
                 t1: Optional[float] = None, *,
                 include_network: bool = True) -> float:
        """∫P dt — over [t0, t1] when given (mirroring
        :meth:`total_flops`'s windowed form, edge-interpolated), else
        the whole trace."""
        total = self.power_w
        net = self.components.get(NETWORK)
        if include_network and net is not None:
            total = total + net
        if t0 is None and t1 is None:
            return float(trapezoid(total, self.t))
        t0 = float(self.t[0]) if t0 is None else t0
        t1 = float(self.t[-1]) if t1 is None else t1
        return self._window_integral(total, t0, t1)

    def component_energy_j(self) -> Dict[str, float]:
        return {name: float(trapezoid(w, self.t))
                for name, w in self.components.items()}

    def scaled(self, factor: float) -> "PowerTrace":
        """Power/flops scaled by ``factor`` (e.g. node trace → k nodes)."""
        return PowerTrace(self.t.copy(),
                          {k: w * factor for k, w in self.components.items()},
                          self.flops_rate * factor,
                          aux=dict(self.aux), meta=dict(self.meta))


@dataclass
class _Chunk:
    """One sealed columnar block of samples (all arrays share a length)."""

    t: np.ndarray
    comps: Dict[str, np.ndarray]
    flops: np.ndarray
    aux: Dict[str, np.ndarray]


class TraceRecorder:
    """Telemetry event bus: workloads ``emit`` samples (or whole series
    via ``emit_series``), consumers take the assembled
    :class:`PowerTrace`.

    With ``dt_s`` set, ``trace()`` resamples every series onto the fixed
    interval grid (RAPS-style); otherwise the raw emission times are
    kept.  Components missing from a sample read as 0 W at that time.

    Internally columnar: scalar emissions append to per-series lists
    (sealed into a chunk lazily), bulk emissions become chunks directly,
    and ``trace()`` concatenates — sorting only if some emission
    actually arrived out of time order.
    """

    def __init__(self, *, dt_s: Optional[float] = None, source: str = ""):
        self.dt_s = dt_s
        self.source = source
        self._chunks: List[_Chunk] = []
        # open scalar-append buffer (column lists, zero-backfilled)
        self._buf_t: List[float] = []
        self._buf_flops: List[float] = []
        self._buf_comp: Dict[str, List[float]] = {}
        self._buf_aux: Dict[str, List[float]] = {}
        self._n = 0
        self._t_max = -np.inf      # running max → O(1) t_last
        self._t_prev = -np.inf     # last emission time → ordered flag
        self._ordered = True

    def __len__(self) -> int:
        return self._n

    @property
    def t_last(self) -> float:
        """Latest emitted sample time (0.0 on an empty recorder) — lets
        sequential phases stack onto one shared bus."""
        return float(self._t_max) if self._n else 0.0

    def _note_times(self, t_first: float, t_last: float,
                    monotonic: bool) -> None:
        if not monotonic or t_first < self._t_prev:
            self._ordered = False
        self._t_prev = t_last
        if t_last > self._t_max:
            self._t_max = t_last

    def emit(self, t: float, watts: Dict[str, float], *,
             flops_rate: float = 0.0, **aux: float) -> None:
        """Record one sample: absolute time [s], component watts,
        instantaneous GFLOPS, and any extra series (util=, f_mhz=,
        temp_c=, …)."""
        t = float(t)
        self._note_times(t, t, True)
        n = len(self._buf_t)
        self._buf_t.append(t)
        self._buf_flops.append(float(flops_rate))
        for k, v in watts.items():
            col = self._buf_comp.get(k)
            if col is None:             # late-appearing component: backfill
                col = self._buf_comp[k] = [0.0] * n
            col.append(float(v))
        for k, v in aux.items():
            col = self._buf_aux.get(k)
            if col is None:
                col = self._buf_aux[k] = [0.0] * n
            col.append(float(v))
        m = n + 1
        for col in self._buf_comp.values():
            if len(col) < m:            # component absent this sample: 0 W
                col.append(0.0)
        for col in self._buf_aux.values():
            if len(col) < m:
                col.append(0.0)
        self._n += 1

    def emit_series(self, t, watts: Dict[str, np.ndarray], *,
                    flops_rate=0.0, **aux) -> None:
        """Bulk columnar emission: a whole time series of samples in one
        call — the vectorized engines' path.  ``t`` is a 1-D array of
        sample times; component/aux values and ``flops_rate`` may be
        arrays of the same length or scalars (broadcast)."""
        t = np.asarray(t, dtype=float)
        if t.ndim != 1 or t.size == 0:
            raise ValueError("emit_series needs a non-empty 1-D time array")
        self._seal_buffer()
        n = t.shape[0]

        def col(v) -> np.ndarray:
            return np.broadcast_to(np.asarray(v, dtype=float), (n,)).copy()

        self._chunks.append(_Chunk(
            t.copy(), {k: col(v) for k, v in watts.items()},
            col(flops_rate), {k: col(v) for k, v in aux.items()}))
        self._note_times(float(t[0]), float(t[-1]),
                         bool(np.all(np.diff(t) >= 0.0)))
        self._t_max = max(self._t_max, float(np.max(t)))
        self._n += n

    def emit_intervals(self, starts, watts: Dict[str, np.ndarray], *,
                       span: float, dt_s: float, flops_rate=0.0,
                       **aux) -> None:
        """Piecewise-constant interval ingestion — the event-driven
        engines' path.  ``starts`` are non-decreasing interval start
        times; interval ``i`` spans ``[starts[i], starts[i+1])`` and the
        last one runs to ``span``.  Component/aux values and
        ``flops_rate`` are per-interval arrays (or scalars, broadcast).

        The intervals are broadcast onto a fixed ``dt_s`` sample grid
        over ``[starts[0], span]``: each sample reads the interval it
        falls in, and the final sample at ``t == span`` reads the last
        interval's value (the left limit) so the trapezoid energy covers
        the full span and bills nothing after it."""
        starts = np.asarray(starts, dtype=float)
        if starts.ndim != 1 or starts.size == 0:
            raise ValueError("emit_intervals needs a non-empty 1-D array "
                             "of interval start times")
        if np.any(np.diff(starts) < 0.0):
            raise ValueError("interval starts must be non-decreasing")
        span = float(span)
        if span <= starts[0]:
            raise ValueError(f"span {span} must exceed the first interval "
                             f"start {starts[0]}")
        n_int = starts.shape[0]

        def per_interval(v) -> np.ndarray:
            return np.broadcast_to(np.asarray(v, dtype=float), (n_int,))

        ts = np.arange(starts[0], span, dt_s)
        if not ts.size or ts[-1] < span:
            ts = np.append(ts, span)
        idx = np.searchsorted(starts, np.minimum(ts, span - 1e-9),
                              side="right") - 1
        idx = np.clip(idx, 0, n_int - 1)
        self.emit_series(
            ts, {k: per_interval(v)[idx] for k, v in watts.items()},
            flops_rate=per_interval(flops_rate)[idx],
            **{k: per_interval(v)[idx] for k, v in aux.items()})

    def _seal_buffer(self) -> None:
        """Convert the open scalar-append buffer into a sealed chunk."""
        if not self._buf_t:
            return
        self._chunks.append(_Chunk(
            np.array(self._buf_t),
            {k: np.array(v) for k, v in self._buf_comp.items()},
            np.array(self._buf_flops),
            {k: np.array(v) for k, v in self._buf_aux.items()}))
        self._buf_t, self._buf_flops = [], []
        self._buf_comp, self._buf_aux = {}, {}

    def trace(self) -> PowerTrace:
        if not self._n:
            raise ValueError("TraceRecorder has no samples")
        self._seal_buffer()
        chunks = self._chunks
        comp_names = sorted({k for c in chunks for k in c.comps})
        aux_names = sorted({k for c in chunks for k in c.aux})
        t = np.concatenate([c.t for c in chunks])
        flops = np.concatenate([c.flops for c in chunks])
        comps = {name: np.concatenate(
            [c.comps.get(name, np.zeros(c.t.shape[0])) for c in chunks])
            for name in comp_names}
        aux = {name: np.concatenate(
            [c.aux.get(name, np.zeros(c.t.shape[0])) for c in chunks])
            for name in aux_names}
        if not self._ordered:           # only sort when actually needed
            order = np.argsort(t, kind="stable")
            t, flops = t[order], flops[order]
            comps = {k: w[order] for k, w in comps.items()}
            aux = {k: w[order] for k, w in aux.items()}
        if self.dt_s is not None and t.shape[0] > 1:
            grid = np.arange(t[0], t[-1] + 0.5 * self.dt_s, self.dt_s)
            comps = {n: np.interp(grid, t, w) for n, w in comps.items()}
            aux = {n: np.interp(grid, t, w) for n, w in aux.items()}
            flops = np.interp(grid, t, flops)
            t = grid
        meta: Dict[str, Any] = {}
        if self.source:
            meta["source"] = self.source
        if self.dt_s is not None:
            meta["dt_s"] = self.dt_s
        return PowerTrace(t, comps, flops, aux=aux, meta=meta)
