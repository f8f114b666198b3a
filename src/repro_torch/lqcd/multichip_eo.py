"""The LQCD calibration of the cluster layer: the single-device part of the
JAX package's ``lqcd/multichip_eo.py`` (its lines 437-548).

``measured_lqcd_calibration`` times the executed Schur normal op A†A (four
even-odd D-slash hops, the hand-written kernel on the card), puts the run
on the telemetry bus, and returns an :class:`LQCDCalibration` that
``repro_torch.cluster.workload.LQCDSolveWorkload`` consumes in place of
the analytic S9150 roofline.  The sharded operator (``ShardedWilsonEO``)
and with it ``mesh=`` are not ported yet (ROADMAP A4).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.lcsc_lqcd import (DSLASH_BW_FRACTION,
                                           MULTI_GPU_SLOWDOWN, S9150_BW_GBS)
from repro_torch.device import resolve_device
from repro_torch.lqcd.dirac import dslash_bytes_per_site, dslash_flops_per_site
from repro_torch.lqcd.eo import (eo_pack, pack_gauge, schur_matvec,
                                 schur_matvec_dagger)
from repro_torch.lqcd.su3 import random_field_and_source
from repro_torch.power.model import (H100_SXM, OperatingPoint,
                                     gpu_power_throttled, h100_chip_power)
from repro_torch.power.trace import TraceRecorder


@dataclass(frozen=True)
class LQCDCalibration:
    """LQCD operating figures for the cluster layer.

    ``source="measured"`` entries come from timing the executed normal op
    (:func:`measured_lqcd_calibration`); ``source="analytic"`` restates
    the S9150 roofline (:func:`analytic_lqcd_calibration`) in the same
    shape so :class:`~repro_torch.cluster.workload.LQCDSolveWorkload` can
    consume either and report the delta.
    """

    lattice: Tuple[int, int, int, int]
    n_devices: int
    gflops: float                # sustained over the timed normal ops
    eff_bw_gbs: float            # executed aggregate streaming bandwidth
    busy_w: float                # aggregate device power while busy
    wall_s: float
    energy_j: float              # integrated from the telemetry bus
    source: str = "measured"
    trace: Optional[Any] = field(default=None, repr=False, compare=False)

    @property
    def gflops_per_w(self) -> float:
        return self.gflops / max(self.busy_w, 1e-9)


def _busy_watts(op=None, n_devices: int = 1) -> float:
    """S9150 board watts at ``op`` (the Green500 point by default)."""
    op = op or OperatingPoint.green500()
    return n_devices * gpu_power_throttled(op.f_mhz, op.vid,
                                           temp_c=op.temperature(), util=1.0)


def analytic_lqcd_calibration(lattice: Tuple[int, int, int, int],
                              n_devices: int = 1, op=None,
                              ) -> LQCDCalibration:
    """The S9150 roofline restated as a calibration (fallback path)."""
    volume = int(np.prod(lattice))
    slowdown = 1.0 - (MULTI_GPU_SLOWDOWN if n_devices > 1 else 0.0)
    eff_bw = S9150_BW_GBS * DSLASH_BW_FRACTION * n_devices * slowdown
    bytes_op = 2 * volume * dslash_bytes_per_site(4)
    flops_op = 2 * volume * dslash_flops_per_site()
    wall = bytes_op / (eff_bw * 1e9)
    busy_w = _busy_watts(op, n_devices)
    return LQCDCalibration(tuple(lattice), n_devices, flops_op / wall / 1e9,
                           eff_bw, busy_w, wall, busy_w * wall,
                           source="analytic")


def measured_lqcd_calibration(lattice: Tuple[int, int, int, int]
                              = (8, 8, 8, 16), *, kappa: float = 0.12, mesh=None,
                              reps: int = 5, recorder=None, seed: int = 0,
                              device="cuda") -> LQCDCalibration:
    """Time the executed normal op on one device and put it on the
    telemetry bus.

    Draws a random gauge field and source on ``device`` from ``seed``
    (``random_field_and_source``), applies the Schur normal op A†A once
    to build and warm the kernels, then times ``reps`` applications (CUDA
    events on the card, ``time.perf_counter`` on the CPU).  Wall time
    becomes sustained GFLOPS and streaming bandwidth by the same counts as
    the JAX function; the run is emitted into ``recorder`` (or a private
    bus) and joules are integrated from the trace.

    Busy watts differ from the JAX function on purpose: it pairs its
    measured rate with S9150 watts at an operating point, while this one
    takes the H100 table's HBM-bound watts (``H100_SXM``), measured on
    the card the rate is measured on.  ``mesh`` (the sharded normal op)
    raises ``NotImplementedError`` until ROADMAP A4 ports it.
    """
    if mesh is not None:
        raise NotImplementedError(
            "measured_lqcd_calibration(mesh=...) needs the sharded even-odd "
            "operator, which the port does not have yet (ROADMAP A4)")
    n_dev = 1
    dev = resolve_device(device)
    lattice = tuple(int(s) for s in lattice)
    U, b = random_field_and_source(lattice, seed, dev)
    U_e, U_o = pack_gauge(U)

    def normal(v: torch.Tensor) -> torch.Tensor:
        return schur_matvec_dagger(U_e, U_o,
                                   schur_matvec(U_e, U_o, v, kappa), kappa)

    v = normal(eo_pack(b, 0))                # build + warm
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(reps):
            v = normal(v)
        end.record()
        end.synchronize()
        wall = start.elapsed_time(end) / 1e3
    else:
        t_start = time.perf_counter()
        for _ in range(reps):
            v = normal(v)
        wall = time.perf_counter() - t_start
    wall = max(wall, 1e-9)

    volume = int(np.prod(lattice))
    flops = reps * 2 * volume * dslash_flops_per_site()
    streamed = reps * 2 * volume * dslash_bytes_per_site(4)
    gflops = flops / wall / 1e9
    busy_w = n_dev * h100_chip_power(1.0, 0.0, 1.0, H100_SXM)

    rec = recorder if recorder is not None \
        else TraceRecorder(source="lqcd-calibration")
    t0 = rec.t_last
    for t in (t0, t0 + wall):
        rec.emit(t, {"gpu": busy_w}, flops_rate=gflops, util=1.0)
    trace = rec.trace()
    energy_j = trace.energy_j(t0=t0, t1=t0 + wall)
    return LQCDCalibration(lattice, n_dev, gflops, streamed / wall / 1e9,
                           busy_w, wall, energy_j, source="measured",
                           trace=trace)
