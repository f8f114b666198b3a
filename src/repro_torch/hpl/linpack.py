"""Linpack driver: factor, solve and the HPL residual check, the
counterpart of the JAX package's ``src/repro/hpl/linpack.py``.

The energy plan and the telemetry recorder of the JAX version are not in
the port yet: they read TPU constants and the power engine, which a later
slice brings (ROADMAP A3).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.hpl import HPLConfig
from repro_torch.device import resolve_device
from repro_torch.hpl.lu import blocked_lu, lu_solve


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
    power_trace: Optional[Any] = None


def linpack_residual(a: torch.Tensor, x: torch.Tensor,
                     b: torch.Tensor) -> float:
    """HPL acceptance: ||Ax-b||_inf / (||A||_inf ||x||_inf n eps)."""
    n = a.shape[0]
    eps = torch.finfo(a.dtype).eps
    r = (a @ x - b).abs().max()
    denom = a.abs().sum(dim=1).max() * x.abs().max() * n * eps
    return float(r / torch.clamp(denom, min=1e-30))


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"linpack_run({what}) is not in the port yet: it needs the H100 "
        f"power/chip table, plan_frequency and TraceRecorder (ROADMAP A3)")


def linpack_run(cfg: HPLConfig, *, energy=None, tuned: bool = False,
                recorder=None, device="cuda") -> LinpackResult:
    """Factor, solve and check a random ``cfg.n`` system on ``device``.

    ``a`` and ``b`` are standard normal, drawn from a ``torch.Generator``
    on the device seeded with ``cfg.seed`` (not the JAX package's stream).
    ``wall_s`` is one factorization, ended by a synchronisation on the
    card, with the GEMM library loaded beforehand.  ``useful_flops`` is
    HPL's 2/3 n^3; ``raw_flops`` counts the trailing-update flops this
    port executes on its shrinking windows, sum over steps of 2 nb t^2
    with t the trailing size, which is not the JAX package's count of its
    masked full-width updates: do not compare the two.  Only float32 is
    supported.  ``energy``, ``tuned`` and ``recorder`` raise
    ``NotImplementedError`` until the slices that port them.
    """
    if tuned:
        cfg = cfg.tuned()
    if energy is not None:
        raise _not_ported("energy=...")
    if recorder is not None:
        raise _not_ported("recorder=...")
    if cfg.dtype != "float32":
        raise ValueError(f"the port runs HPL in float32, got {cfg.dtype!r}")
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(cfg.seed)
    a = torch.randn((cfg.n, cfg.n), generator=gen, device=dev)
    b = torch.randn((cfg.n,), generator=gen, device=dev)

    if dev.type == "cuda":
        from repro_torch.kernels.dgemm import kernel
        kernel._lib()                 # build and load before the clock
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
    return LinpackResult(
        n=cfg.n, block=cfg.block, mode=cfg.mode, residual=rnorm,
        passed=bool(rnorm < 16.0), useful_flops=useful, raw_flops=raw,
        wall_s=wall, gflops=useful / wall / 1e9)
