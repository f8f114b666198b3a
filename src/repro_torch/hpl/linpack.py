"""The Linpack run: factor, solve, the HPL residual check and energy
accounting, the counterpart of the JAX package's ``src/repro/hpl/linpack.py``.

Two operating modes (paper §2):
  * ``performance``  — big update blocks, full clock
  * ``efficiency``   — smaller blocks + the DVFS plan's derated clock; a
    small perf sacrifice for better MFLOPS/W (used for the Green500 run)

The energy plan takes its roofline terms and watts from the port's chip
table (``repro_torch.power.model.H100_SXM``), where the JAX version reads
TPU constants.  ``tuned=True`` takes the blocking from the port's
autotuner (``HPLConfig.tuned``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.config import EnergyConfig
from repro_torch.configs.hpl import HPLConfig
from repro_torch.core.energy.dvfs import plan_frequency
from repro_torch.device import resolve_device
from repro_torch.hpl.lu import blocked_lu, lu_solve
from repro_torch.power.model import H100_SXM
from repro_torch.power.trace import PowerTrace, TraceRecorder


@dataclass
class LinpackResult:
    n: int
    block: int
    mode: str
    residual: float
    passed: bool
    useful_flops: float
    raw_flops: float
    wall_s: float
    gflops: float
    energy_plan: Optional[Dict] = None
    power_trace: Optional[PowerTrace] = None


def linpack_residual(a: torch.Tensor, x: torch.Tensor,
                     b: torch.Tensor) -> float:
    """HPL acceptance: ||Ax-b||_inf / (||A||_inf ||x||_inf n eps)."""
    n = a.shape[0]
    eps = torch.finfo(a.dtype).eps
    r = (a @ x - b).abs().max()
    denom = a.abs().sum(dim=1).max() * x.abs().max() * n * eps
    return float(r / torch.clamp(denom, min=1e-30))


def linpack_run(cfg: HPLConfig, *, energy: Optional[EnergyConfig] = None,
                tuned: bool = False,
                recorder: Optional[TraceRecorder] = None,
                device="cuda") -> LinpackResult:
    """Factor, solve and check a random ``cfg.n`` system on ``device``,
    with an energy plan when ``energy`` is given.

    ``a`` and ``b`` are standard normal, drawn from a ``torch.Generator``
    on the device seeded with ``cfg.seed`` (not the JAX package's stream).
    ``wall_s`` is one factorization, ended by a synchronisation on the
    card, with the kernel libraries loaded beforehand.  ``useful_flops`` is
    HPL's 2/3 n^3; ``raw_flops`` counts the trailing-update flops this
    port executes on its shrinking windows, sum over steps of 2 nb t^2
    with t the trailing size, which is not the JAX package's count of its
    masked full-width updates: do not compare the two.  Only float32 is
    supported.

    With ``energy``, the roofline terms of the run on the chip table
    (the GEMM runs IEEE f32 on the CUDA cores: useful flops over the f32
    peak; every step streams the n x n matrix once) feed
    ``plan_frequency``, and the run is emitted into ``recorder`` (or a
    private bus) at the plan's chip watts over the measured wall time,
    after anything already on the bus.  ``recorder`` without ``energy``
    records nothing, as in the JAX version.  ``tuned=True`` replaces the
    blocking and lookahead by the autotuner's for ``cfg.n`` on ``device``
    (``HPLConfig.tuned``), keeping the mode.
    """
    if tuned:
        cfg = cfg.tuned(device)
    if cfg.dtype != "float32":
        raise ValueError(f"the port runs HPL in float32, got {cfg.dtype!r}")
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(cfg.seed)
    a = torch.randn((cfg.n, cfg.n), generator=gen, device=dev)
    b = torch.randn((cfg.n,), generator=gen, device=dev)

    if dev.type == "cuda":
        from repro_torch.kernels.dgemm import kernel
        from repro_torch.kernels.panel import kernel as panel
        kernel._lib()                 # build and load before the clock
        panel._lib()
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = blocked_lu(a, cfg.block, lookahead=cfg.lookahead)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    x = lu_solve(res, b, cfg.block)
    rnorm = linpack_residual(a, x, b)

    useful = 2.0 / 3.0 * cfg.n ** 3
    raw = sum(2.0 * cfg.block * (cfg.n - k1) ** 2
              for k1 in range(cfg.block, cfg.n, cfg.block))

    plan = None
    trace = None
    if energy is not None:
        chip = H100_SXM
        steps = cfg.n // cfg.block
        compute_s = useful / chip.peak_f32_flops
        memory_s = (cfg.n * cfg.n * a.element_size() * steps) / chip.hbm_bw
        fp = plan_frequency(compute_s, memory_s, 0.0, flops_per_step=useful,
                            cfg=energy, chip=chip)
        plan = {"freq_scale": fp.freq_scale, "power_w": fp.power_w,
                "energy_per_run_j": fp.energy_per_step_j,
                "perf_loss": fp.perf_loss, "dominant": fp.dominant}
        rec = recorder if recorder is not None \
            else TraceRecorder(source="hpl.linpack")
        t0 = rec.t_last
        for t in (t0, t0 + wall):
            rec.emit(t, {"chip": fp.power_w},
                     flops_rate=useful / wall / 1e9,
                     freq_scale=fp.freq_scale, util=1.0)
        trace = rec.trace()

    return LinpackResult(
        n=cfg.n, block=cfg.block, mode=cfg.mode, residual=rnorm,
        passed=bool(rnorm < 16.0), useful_flops=useful, raw_flops=raw,
        wall_s=wall, gflops=useful / wall / 1e9, energy_plan=plan,
        power_trace=trace)
