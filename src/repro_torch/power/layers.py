"""Layered power composition: GPU → node → rack → cluster (a copy of the
JAX package's ``power/layers.py``).

The paper's headline numbers are *cluster-level* wall-plug measurements
(compute nodes + PSU losses + fans + network switches, §3–4).  This
module composes them from the device models in
:mod:`repro_torch.power.model`
so the published 1021 W/node and 57.2 kW cluster figures fall out of
aggregation rather than being hard-coded:

  :class:`GPUModel`      one ASIC (voltage ID binds the chip's bin)
  :class:`NodeModel`     host + 4×S9150 + fans, behind a PSU-efficiency
                         curve (DC components / η(load) = wall watts)
  :class:`RackModel`     nodes, aggregated per component
  :class:`ClusterModel`  racks + network switches (measured separately
                         at Green500 Level 3: 257 W for L-CSC)

Every layer implements the :class:`repro_torch.power.model.PowerModel`
protocol, so traces, benchmarks and the autotuner can query any level.

Calibration: the GPU/fan curves are wall-calibrated legacy constants
re-interpreted as DC-side draw; ``P_HOST_DC_W`` and the PSU curve are
chosen so the composed wall power at the Green500 operating point
reproduces the published ~1021 W/node (ESC4000-class servers: 1620 W
redundant PSUs, ~94% peak efficiency near half load).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.power.model import (S9150, GPUSpec, OperatingPoint,
                                     V_MIN, fan_power, gpu_power,
                                     gpu_power_throttled, uniform_vids)

# A batched entry point accepts either one shared operating point or a
# per-chip / per-sample spread of them (resolved through op_bins).
OpOrSpread = Union[OperatingPoint, Sequence[OperatingPoint]]


def op_bins(ops: Sequence[OperatingPoint],
            ) -> Tuple[List[OperatingPoint], np.ndarray]:
    """Dedupe an operating-point spread into ``(bins, index)``: ``bins``
    holds the distinct points in first-seen order and ``index[i]`` is the
    bin of ``ops[i]``.  The batched layer entry points evaluate the
    scalar device model once per *bin* — not once per chip or sample —
    and gather through the index, so a heterogeneous population costs
    as many model evaluations as it has distinct operating points."""
    bins: List[OperatingPoint] = []
    where: Dict[OperatingPoint, int] = {}
    index = np.empty(len(ops), dtype=np.intp)
    for i, o in enumerate(ops):
        b = where.get(o)
        if b is None:
            b = where[o] = len(bins)
            bins.append(o)
        index[i] = b
    return bins, index

# Host DC draw: 2x10-core CPUs + 256 GB DIMMs + chipset + IB HCA.  The
# legacy flat model charged the host 200 W *at the wall*; the composed
# model splits that into 137.8 W of DC draw plus its share of PSU loss.
P_HOST_DC_W = 137.8

# PSU calibration (1620 W redundant supplies, platinum-class curve)
PSU_RATED_W = 1620.0
PSU_EFF_PEAK = 0.94
PSU_LOAD_PEAK = 0.5
PSU_EFF_CURVATURE = 0.12


@dataclass(frozen=True)
class PSUCurve:
    """Wall↔DC conversion: η(load) peaks near half load and falls off
    quadratically toward idle and full load (80 Plus Platinum shape)."""

    rated_w: float = PSU_RATED_W
    eff_peak: float = PSU_EFF_PEAK
    load_peak: float = PSU_LOAD_PEAK
    curvature: float = PSU_EFF_CURVATURE

    def efficiency(self, dc_w):
        """η(load) — array-aware: a DC-draw series maps elementwise."""
        load = np.clip(np.asarray(dc_w, dtype=float) / self.rated_w,
                       0.02, 1.2)
        eff = self.eff_peak - self.curvature * (load - self.load_peak) ** 2
        return float(eff) if np.ndim(dc_w) == 0 else eff

    def wall_power(self, dc_w):
        return dc_w / self.efficiency(dc_w)

    def loss_w(self, dc_w):
        return self.wall_power(dc_w) - dc_w


LCSC_PSU = PSUCurve()


@dataclass(frozen=True)
class GPUModel:
    """One ASIC: the voltage ID binds the chip's manufacturing bin."""

    vid: float = V_MIN
    spec: GPUSpec = S9150

    def component_watts(self, op: OperatingPoint, *, load: float = 1.0,
                        fan: Optional[float] = None) -> Dict[str, float]:
        return {"gpu": self.power(op, load=load)}

    def power(self, op: OperatingPoint, *, load: float = 1.0,
              fan: Optional[float] = None) -> float:
        """TDP-clamped board draw at the operating point; ``load`` scales
        the duty cycle (telemetry replay / end-of-run tail)."""
        return gpu_power_throttled(op.f_mhz, self.vid,
                                   temp_c=op.temperature(),
                                   util=op.gpu_util() * load,
                                   tdp_w=self.spec.tdp_w)

    def power_batch(self, op: OpOrSpread, *, load) -> np.ndarray:
        """Vectorized :meth:`power`: an array of duty-cycle loads maps
        elementwise to board watts (same model, one ufunc pass).

        ``op`` may also be a per-sample *spread* of operating points
        (zipped elementwise with ``load``): the spread is deduped into
        per-bin (clock, temperature, utilization) lookup tables via
        :func:`op_bins`, so sample ``i`` draws exactly what
        ``power(op[i], load=load[i])`` returns — bit-for-bit."""
        if isinstance(op, OperatingPoint):
            return gpu_power_throttled(op.f_mhz, self.vid,
                                       temp_c=op.temperature(),
                                       util=op.gpu_util()
                                       * np.asarray(load, dtype=float),
                                       tdp_w=self.spec.tdp_w)
        bins, idx = op_bins(op)
        f = np.array([o.f_mhz for o in bins])[idx]
        temp = np.array([o.temperature() for o in bins])[idx]
        util = np.array([o.gpu_util() for o in bins])[idx]
        return gpu_power_throttled(f, self.vid, temp_c=temp,
                                   util=util * np.asarray(load, dtype=float),
                                   tdp_w=self.spec.tdp_w)

    def component_watts_batch(self, op: OpOrSpread, *,
                              load) -> Dict[str, np.ndarray]:
        return {"gpu": self.power_batch(op, load=load)}

    def unconstrained_power(self, op: OperatingPoint, *,
                            load: float = 1.0) -> float:
        """Model draw ignoring the TDP clamp (Fig. 1b style sweeps)."""
        return gpu_power(op.f_mhz, self.vid, temp_c=op.temperature(),
                         util=op.gpu_util() * load, spec=self.spec)


@dataclass(frozen=True)
class NodeModel:
    """Host + GPUs + fans behind the PSU-efficiency curve.

    ``component_watts`` values are wall-referred: the DC components are
    reported as-is and the conversion loss appears as ``psu_loss``, so
    the dict sums to wall power."""

    gpus: Tuple[GPUModel, ...] = field(
        default_factory=lambda: tuple(GPUModel() for _ in range(4)))
    host_dc_w: float = P_HOST_DC_W
    psu: PSUCurve = LCSC_PSU

    @classmethod
    def from_vids(cls, vids: Sequence[float], *,
                  spec: GPUSpec = S9150) -> "NodeModel":
        return cls(gpus=tuple(GPUModel(float(v), spec) for v in vids))

    @property
    def vids(self) -> Tuple[float, ...]:
        return tuple(g.vid for g in self.gpus)

    def component_watts(self, op: OperatingPoint, *, load: float = 1.0,
                        fan: Optional[float] = None,
                        gpu_w_override: Optional[Sequence[float]] = None,
                        ) -> Dict[str, float]:
        gpu_dc = None if gpu_w_override is None \
            else float(np.sum(gpu_w_override))
        watts = self.component_watts_series(op, load=load, fan=fan,
                                            gpu_dc=gpu_dc)
        return {k: float(v) for k, v in watts.items()}

    def component_watts_series(self, op: OpOrSpread, *, load=1.0,
                               fan=None, gpu_dc=None,
                               ) -> Dict[str, np.ndarray]:
        """Batched :meth:`component_watts` over a *time series*: ``load``
        and/or ``fan`` may be arrays (one entry per sample) and every
        returned component is an array of the common broadcast shape.
        ``op`` may be a per-sample spread of operating points (see
        :func:`op_bins`); the fan duty then defaults to each sample's
        own point.  ``gpu_dc`` short-circuits the GPU model with a
        precomputed DC draw per sample (the occupancy engine's path)."""
        if isinstance(op, OperatingPoint):
            duty = op.fan if fan is None else fan
        else:
            duty = np.array([o.fan for o in op]) if fan is None else fan
        if gpu_dc is None:
            gpu_dc = 0.0
            for g in self.gpus:
                gpu_dc = gpu_dc + g.power_batch(op, load=load)
        fan_dc = fan_power(duty)
        dc = self.host_dc_w + gpu_dc + fan_dc
        shape = np.shape(dc)

        def full(v):
            return np.broadcast_to(np.asarray(v, dtype=float), shape).copy()

        return {"gpu": full(gpu_dc), "host": full(self.host_dc_w),
                "fan": full(fan_dc), "psu_loss": full(self.psu.loss_w(dc))}

    def component_watts_batch(self, op: OperatingPoint, busy_counts, *,
                              fan=None, chip_ops:
                              Optional[Sequence[OperatingPoint]] = None,
                              ) -> Dict[str, np.ndarray]:
        """Batched :meth:`component_watts` over *occupancy*.

        Homogeneous form (``chip_ops=None``): ``busy_counts`` is an
        integer array of busy-chip counts (0 … ``len(self.gpus)``); each
        distinct count is evaluated once through the scalar GPU model (a
        ``len(gpus)+1``-entry lookup table) and broadcast — ``gpus[0]``
        binds the bin for the whole population.

        Heterogeneous form: ``chip_ops`` gives every chip its own
        operating point (clock/vid/fan spread) and ``busy_counts``
        becomes a boolean occupancy mask whose trailing axis is the chip
        axis.  Each chip's busy/idle watts are evaluated once through
        *its own* scalar model (a per-chip two-entry lookup table — the
        per-bin generalization), summed in chip order, so per-sample
        totals match the scalar ``component_watts(gpu_w_override=...)``
        path bit-for-bit.  ``op`` still sets the node-level fan default.

        NOTE: the homogeneous count table adds busy chips first, which
        may differ in the last ulp from a mixed chip-order sum, so that
        convenience form must not replace the engine's chip-order sum."""
        g = len(self.gpus)
        if chip_ops is not None:
            if len(chip_ops) != g:
                raise ValueError(f"chip_ops must give one operating point "
                                 f"per chip ({g}), got {len(chip_ops)}")
            mask = np.asarray(busy_counts, dtype=bool)
            if mask.shape[-1:] != (g,):
                raise ValueError(f"with chip_ops, busy_counts is a boolean "
                                 f"mask whose last axis is the chip axis "
                                 f"({g}); got shape {mask.shape}")
            w_busy = np.array([gpu.power(o, load=1.0)
                               for gpu, o in zip(self.gpus, chip_ops)])
            w_idle = np.array([gpu.power(o, load=0.0)
                               for gpu, o in zip(self.gpus, chip_ops)])
            gpu_dc = np.sum(np.where(mask, w_busy, w_idle), axis=-1)
            return self.component_watts_series(op, fan=fan, gpu_dc=gpu_dc)
        counts = np.asarray(busy_counts, dtype=np.intp)
        if counts.size and (counts.min() < 0 or counts.max() > g):
            raise ValueError(f"busy counts must lie in [0, {g}]")
        w_busy = self.gpus[0].power(op, load=1.0)
        w_idle = self.gpus[0].power(op, load=0.0)
        table = np.array([float(np.sum([w_busy] * b + [w_idle] * (g - b)))
                          for b in range(g + 1)])
        return self.component_watts_series(op, fan=fan,
                                           gpu_dc=table[counts])

    def power(self, op: OperatingPoint, *, load: float = 1.0,
              fan: Optional[float] = None,
              gpu_w_override: Optional[Sequence[float]] = None) -> float:
        return float(sum(self.component_watts(
            op, load=load, fan=fan, gpu_w_override=gpu_w_override).values()))


@dataclass(frozen=True)
class RackModel:
    """Per-component aggregation over a rack's nodes."""

    nodes: Tuple[NodeModel, ...]

    def component_watts(self, op: OperatingPoint, *, load: float = 1.0,
                        fan: Optional[float] = None) -> Dict[str, float]:
        return {k: float(v) for k, v in self.component_watts_series(
            op, load=load, fan=fan).items()}

    def component_watts_series(self, op: OperatingPoint, *, load=1.0,
                               fan=None) -> Dict[str, np.ndarray]:
        """Batched :meth:`component_watts` over a load/fan time series
        (the scalar API is a thin wrapper over this path)."""
        total: Dict[str, np.ndarray] = {}
        for node in self.nodes:
            for name, w in node.component_watts_series(op, load=load,
                                                       fan=fan).items():
                total[name] = total.get(name, 0.0) + w
        return total

    def power(self, op: OperatingPoint, *, load: float = 1.0,
              fan: Optional[float] = None) -> float:
        return float(sum(self.component_watts(op, load=load,
                                              fan=fan).values()))


@dataclass(frozen=True)
class ClusterModel:
    """Racks + network switches (the L3-measured 257 W for L-CSC)."""

    racks: Tuple[RackModel, ...]
    network_w: float = 0.0

    @property
    def nodes(self) -> Tuple[NodeModel, ...]:
        return tuple(n for r in self.racks for n in r.nodes)

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def component_watts(self, op: OperatingPoint, *, load: float = 1.0,
                        fan: Optional[float] = None,
                        include_network: bool = True) -> Dict[str, float]:
        return {k: float(v) for k, v in self.component_watts_series(
            op, load=load, fan=fan,
            include_network=include_network).items()}

    def component_watts_series(self, op: OperatingPoint, *, load=1.0,
                               fan=None, include_network: bool = True,
                               ) -> Dict[str, np.ndarray]:
        """Batched :meth:`component_watts` over a load/fan time series —
        what the vectorized :func:`repro_torch.power.engine.simulate`
        drives
        (the scalar API is a thin wrapper over this path)."""
        total: Dict[str, np.ndarray] = {}
        for rack in self.racks:
            for name, w in rack.component_watts_series(op, load=load,
                                                       fan=fan).items():
                total[name] = total.get(name, 0.0) + w
        if include_network:
            shape = np.shape(next(iter(total.values()))) if total \
                else np.broadcast(np.asarray(load, dtype=float),
                                  np.asarray(op.fan if fan is None else fan,
                                             dtype=float)).shape
            total["network"] = np.full(shape, self.network_w)
        return total

    def power(self, op: OperatingPoint, *, load: float = 1.0,
              fan: Optional[float] = None,
              include_network: bool = True) -> float:
        return float(sum(self.component_watts(
            op, load=load, fan=fan,
            include_network=include_network).values()))


def lcsc_node(vids: Optional[Sequence[float]] = None) -> NodeModel:
    """One L-CSC compute node: host + 4×S9150 + fans + PSU."""
    return NodeModel.from_vids(uniform_vids(4) if vids is None else vids)


def lcsc_cluster(n_nodes: int = 56, *, nodes_per_rack: int = 8,
                 network_w: Optional[float] = None,
                 vids: Optional[Sequence[Sequence[float]]] = None,
                 ) -> ClusterModel:
    """The Green500-run cluster: 56 nodes in racks of 8, plus the
    separately-metered Mellanox switches (paper §3: 257 W)."""
    if network_w is None:
        from repro_torch.configs.lcsc_lqcd import GREEN500_SWITCH_POWER_W
        network_w = GREEN500_SWITCH_POWER_W
    if vids is None:
        node_vids: Sequence[Sequence[float]] = [uniform_vids(4)] * n_nodes
    else:
        node_vids = vids
        if len(node_vids) != n_nodes:
            raise ValueError(f"need {n_nodes} vid tuples, got "
                             f"{len(node_vids)}")
    nodes = [lcsc_node(v) for v in node_vids]
    racks = tuple(RackModel(tuple(nodes[i:i + nodes_per_rack]))
                  for i in range(0, n_nodes, nodes_per_rack))
    return ClusterModel(racks, network_w=float(network_w))


# ---------------------------------------------------------------------------
# Legacy flat-node API (kept for the pre-refactor call sites; the shim in
# core/energy/power_model.py re-exports these)
# ---------------------------------------------------------------------------


def node_power(f_mhz: float, vids: Sequence[float], *, fan: float = 0.40,
               temp_c: float = 55.0, util: float = 1.0,
               gpu_clamped_w: Optional[Sequence[float]] = None) -> float:
    """Total node wall power via the composed model.  If
    ``gpu_clamped_w`` is given (post-throttle), use it; otherwise
    evaluate the unconstrained GPU model (legacy semantics)."""
    op = OperatingPoint(f_mhz=f_mhz, fan=fan, temp_c=temp_c, util=util)
    node = NodeModel.from_vids(vids)
    if gpu_clamped_w is None:
        gpu_clamped_w = [g.unconstrained_power(op) for g in node.gpus]
    return node.power(op, gpu_w_override=gpu_clamped_w)


@dataclass
class NodePowerModel:
    """Convenience wrapper binding a node's chip population."""

    vids: Sequence[float]
    fan: float = 0.40
    temp_c: float = 55.0
    spec: GPUSpec = S9150

    def power(self, f_mhz: float, util: float = 1.0,
              gpu_clamped_w: Optional[Sequence[float]] = None) -> float:
        return node_power(f_mhz, self.vids, fan=self.fan, temp_c=self.temp_c,
                          util=util, gpu_clamped_w=gpu_clamped_w)

    def with_fan(self, fan: float) -> "NodePowerModel":
        import dataclasses
        return dataclasses.replace(self, fan=fan)
