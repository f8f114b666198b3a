#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

  python3 chip_smoke.py

Phases (one line each, or a few):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (both families, one nvcc each, in parallel)
     from the sources in this checkout;
  3. each kernel against its plain PyTorch version on the card, at the
     thermal lattice 32^3 x 8 (both even-odd source parities, and the full
     hop), rtol = atol = 1e-4;
  4. the main path: ``solve_dirac(U, b, 0.137, EO_MIXED_SOLVER)`` at 32^3 x 8
     on seeded right-hand sides, with the kernels' launch counts read
     around it; then a small lattice solved on the CPU (plain versions) and
     on the card (kernels), which must agree;
  5. ``solve_dirac(..., PLAIN_SOLVER)`` at 32^3 x 8;
  6. each kernel's time (CUDA events) beside its bound and its plain
     version's time;
  7. the GEMM kernel (both entry points) against its plain version on the
     card: the JAX sweep's shapes in f32 and bf16 at its tolerances, a
     ragged shape, unaligned strided views, and HPL's step-0 trailing
     update at n = 32768 on views of one matrix, in f32;
  8. the second path: ``linpack_run(HPLConfig(n=32768, block=256,
     lookahead=1))``, which must pass HPL's residual check and launch the
     GEMM as often as n, block and lookahead imply; then one n = 1024
     matrix factored on the CPU (plain) and on the card (kernel), which
     must agree; then where the time goes: one factorization at n = 8192
     with and without torch.profiler (device time by kernel, the device's
     idle share);
  9. the step-0 update's time beside its bound, its plain version's and
     the library's (``addmm_``; ``torch.matmul`` of the product alone is
     printed too).
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises: the script then
exits non-zero and prints no result.  It needs a CUDA device and the
``src/repro_torch`` package beside it.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

KAPPA = 0.137
SEED = 0
N_RHS = 2
TOL = 1e-4                      # rtol = atol: tests/test_kernels.py sweep
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
F32_FLOP_PER_S = 67e12          # H100 SXM data sheet, f32 outside tensor cores
SOURCE = "src/repro_torch/kernels/dslash/csrc/dslash.cu"
REPLACES = {"dslash_eo_split": "src/repro/kernels/dslash/kernel.py:180",
            "dslash_split": "src/repro/kernels/dslash/kernel.py:217"}
GEMM_SOURCE = "src/repro_torch/kernels/dgemm/csrc/dgemm.cu"
GEMM_REPLACES = "src/repro/kernels/dgemm/kernel.py:30"
# tests/test_kernels.py::test_dgemm_sweep: shapes (m, n, k), tolerances
GEMM_SWEEP = [(128, 128, 128), (256, 128, 384), (512, 256, 128)]
GEMM_RAGGED = (1000, 333, 259)
HPL_N, HPL_NB, HPL_LOOKAHEAD = 32768, 256, 1
SMALL_HPL_SEED = 20             # see phase 8
HPL_PROFILE_N = 8192


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def timed_ms(fn, reps: int, warmup: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(in_out, sites: int, flops_per_site: int) -> tuple[float, str]:
    """Least time (ms) for the work: each input read once and the output
    written once at the HBM rate, or the flops at the f32 rate."""
    nbytes = sum(t.numel() * t.element_size() for t in in_out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = sites * flops_per_site / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def hpl_profile(blocked_lu, a) -> None:
    """Factor ``a`` once plain and once under torch.profiler; print the
    wall times, the device's busy time by kernel and its idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    n = a.shape[0]

    def factor() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blocked_lu(a, HPL_NB, lookahead=HPL_LOOKAHEAD)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = [factor()]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        walls.append(factor())
    busy, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = "gemm_kernel" if "gemm_kernel" in e.name else e.name
            busy[name] = busy.get(name, 0.0) + e.device_time_total / 1e6
            count[name] = count.get(name, 0) + 1
    total = sum(busy.values())
    gemm = busy.pop("gemm_kernel", 0.0), count.pop("gemm_kernel", 0)
    print(f"[8] where the time goes, blocked_lu at n={n}, nb={HPL_NB}: "
          f"{walls[0]:.3f} s plain, {walls[1]:.3f} s under the profiler; "
          f"device busy {total:.3f} s ({100 * total / walls[1]:.1f}% of the "
          f"profiled wall, idle {100 - 100 * total / walls[1]:.1f}%): the "
          f"GEMM kernel {gemm[0]:.4f} s in {gemm[1]} launches, the rest "
          f"{total - gemm[0]:.4f} s in {sum(count.values())} device "
          f"activities ({sum(count.values()) / n:.1f} per column); the "
          f"largest of those:")
    for name in sorted(busy, key=busy.get, reverse=True)[:5]:
        print(f"    {busy[name]:.4f} s in {count[name]} x {name[:90]}")


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch import convert
    from repro_torch.configs.lcsc_lqcd import (EO_MIXED_SOLVER, PLAIN_SOLVER,
                                               THERMAL_LATTICE)
    from repro_torch.configs.hpl import DEFAULT_HPL, HPLConfig
    from repro_torch.hpl import blocked_lu, linpack_run, lu_solve
    from repro_torch.kernels import _build
    from repro_torch.kernels.dgemm import kernel as G
    from repro_torch.kernels.dgemm.ref import dgemm_ref, dgemm_update_ref_
    from repro_torch.kernels.dslash import kernel as K
    from repro_torch.kernels.dslash.ref import (dslash_eo_split_ref,
                                                dslash_split_ref, to_split)
    from repro_torch.lqcd import (dslash_flops_per_site, eo_pack, pack_gauge,
                                  solve_dirac, su3_project)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1] card: {kind}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; TF32 off for matmul and cuDNN (the plain "
          f"versions must run in full f32)")

    # 2. build
    t0 = time.perf_counter()
    _build.build(["dslash", "dgemm"])
    K._lib()
    G._lib()
    print(f"[2] built {_build.library_path('dslash').name} and "
          f"{_build.library_path('dgemm').name} in "
          f"{time.perf_counter() - t0:.2f} s")
    for family in ("dslash", "dgemm"):
        for line in _build.build_log(family).splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas ({family}): {line.strip()}")

    rng = np.random.default_rng(SEED)

    def gauge(shape, device):
        m = (rng.standard_normal((4,) + shape + (3, 3))
             + 1j * rng.standard_normal((4,) + shape + (3, 3)))
        return su3_project(convert.gauge_from_numpy(m, device))

    def spinor(shape, device):
        return convert.spinor_from_numpy(
            rng.standard_normal(shape + (4, 3))
            + 1j * rng.standard_normal(shape + (4, 3)), device)

    # 3. kernels against their plain versions at the thermal shapes
    lat = THERMAL_LATTICE.shape
    U = gauge(lat, dev)
    psi = spinor(lat, dev)
    U_e, U_o = pack_gauge(U)
    err = {}
    U_s, psi_s = to_split(U), to_split(psi)
    got = K.dslash_split(U_s, psi_s)
    want = dslash_split_ref(U_s, psi_s)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    err["dslash_split"] = float((got - want).abs().max())
    eo_err = []
    for src_parity in (0, 1):
        U_out, U_src = (U_o, U_e) if src_parity == 0 else (U_e, U_o)
        args = (to_split(U_out), to_split(U_src),
                to_split(eo_pack(psi, src_parity)), src_parity)
        got = K.dslash_eo_split(*args)
        want = dslash_eo_split_ref(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
        eo_err.append(float((got - want).abs().max()))
    err["dslash_eo_split"] = max(eo_err)
    print(f"[3] kernels vs plain at {lat}, rtol=atol={TOL}: dslash_split "
          f"max|err| {err['dslash_split']:.3e}; dslash_eo_split max|err| "
          f"{eo_err[0]:.3e} (even src), {eo_err[1]:.3e} (odd src)")

    # 4. the main path: even-odd mixed-precision solve
    rhs = [spinor(lat, dev) for _ in range(N_RHS)]
    torch.cuda.synchronize()
    K.reset_launches()
    results = []
    for b in rhs:
        t0 = time.perf_counter()
        res = solve_dirac(U, b, KAPPA, EO_MIXED_SOLVER)
        torch.cuda.synchronize()
        results.append((res, time.perf_counter() - t0))
    launches = dict(K.LAUNCHES)
    inner_total = 0
    for k, (res, wall) in enumerate(results):
        print(f"[4] EO_MIXED_SOLVER rhs {k}: {res.iters} inner normal ops + "
              f"{res.outer_iters} outer, true rel. residual "
              f"{res.rel_residual:.3e}, converged {res.converged}, "
              f"{wall * 1e3:.1f} ms wall")
        check(res.converged and res.rel_residual <= 1e-6,
              f"rhs {k} converged to rel. residual <= 1e-6")
        check(tuple(res.x.shape) == lat + (4, 3)
              and bool(torch.isfinite(torch.view_as_real(res.x)).all()),
              f"rhs {k} solution finite, of shape {lat + (4, 3)}")
        inner_total += res.iters
    print(f"[4] launches on the main path: {launches}")
    check(launches["dslash_eo_split"] >= 4 * inner_total,
          "dslash_eo_split launched >= 4 x inner iterations")
    check(launches["dslash_split"] >= 1, "dslash_split launched")
    # the residual again, through the plain full hop instead of the kernel
    for k, ((res, _), b) in enumerate(zip(results, rhs)):
        mx = res.x - KAPPA * torch.view_as_complex(
            dslash_split_ref(U_s, to_split(res.x)))
        rel = float(torch.linalg.vector_norm(b - mx)
                    / torch.linalg.vector_norm(b))
        print(f"[4] rhs {k}: rel. residual through the plain D-slash "
              f"{rel:.3e}")
        # the two hops sum in other orders: the residual moves by ~1e-7
        check(rel <= 2e-6, f"rhs {k} plain-path residual <= 2e-6")
    # small lattice: the kernels' solve against the plain versions' on CPU
    small = (8, 8, 8, 8)
    U_c = gauge(small, "cpu")
    b_c = spinor(small, "cpu")
    r_cpu = solve_dirac(U_c, b_c, KAPPA, EO_MIXED_SOLVER)
    r_gpu = solve_dirac(U_c.to(dev), b_c.to(dev), KAPPA, EO_MIXED_SOLVER)
    dx = float((r_gpu.x.cpu() - r_cpu.x).abs().max())
    print(f"[4] {small} CPU plain vs card kernels: iters {r_cpu.iters}+"
          f"{r_cpu.outer_iters} vs {r_gpu.iters}+{r_gpu.outer_iters}, "
          f"max|dx| {dx:.2e}")
    check(r_cpu.converged and r_gpu.converged, "small solves converged")
    check(abs(r_cpu.iters - r_gpu.iters) <= 2 and dx <= 2e-4,
          "small solve on the card agrees with the CPU")

    # 5. plain CGNE: the full-lattice kernel in every iteration
    b = rhs[0]
    K.reset_launches()
    t0 = time.perf_counter()
    res = solve_dirac(U, b, KAPPA, PLAIN_SOLVER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[5] PLAIN_SOLVER: {res.iters} normal ops, true rel. residual "
          f"{res.rel_residual:.3e}, converged {res.converged}, "
          f"{wall * 1e3:.1f} ms wall, launches {dict(K.LAUNCHES)}")
    check(res.converged, "plain solve converged")
    check(K.LAUNCHES["dslash_split"] >= 2 * res.iters,
          "dslash_split launched >= 2 x plain normal ops")

    # 6. timing at the thermal shapes
    records = []
    psi_h = to_split(eo_pack(psi, 0))
    eo_args = (to_split(U_o), to_split(U_e), psi_h, 0)
    cases = [
        ("dslash_eo_split", lambda: K.dslash_eo_split(*eo_args),
         lambda: dslash_eo_split_ref(*eo_args),
         [eo_args[0], eo_args[1], psi_h, psi_h], psi_h.shape[:4].numel()),
        ("dslash_split", lambda: K.dslash_split(U_s, psi_s),
         lambda: dslash_split_ref(U_s, psi_s),
         [U_s, psi_s, psi_s], psi_s.shape[:4].numel()),
    ]
    for name, kern, plain, in_out, sites in cases:
        ms = timed_ms(kern, reps=200, warmup=20)
        plain_ms = timed_ms(plain, reps=5, warmup=2)
        b_ms, b_by = bound(in_out, sites, dslash_flops_per_site())
        nbytes = sum(t.numel() * t.element_size() for t in in_out)
        print(f"[6] {name}: {ms * 1e3:.1f} us, {nbytes / ms / 1e6:.0f} GB/s, "
              f"{100 * b_ms / ms:.1f}% of the {b_ms * 1e3:.1f} us "
              f"{b_by} bound; plain {plain_ms:.3f} ms; library_ms: n/a "
              f"(no PyTorch call computes D-slash)")
        records.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[name],
                        "launches": launches[name],
                        "max_abs_err": err[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})

    # 7. the GEMM kernel against its plain version on the card
    gen = torch.Generator(dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    gemm_tol = {torch.float32: dict(rtol=2e-5, atol=1e-3),
                torch.bfloat16: dict(rtol=0.1, atol=0.1)}
    for m, n, k in GEMM_SWEEP + [GEMM_RAGGED]:
        for dtype in (torch.float32, torch.bfloat16):
            x, y, c = randn(m, k, dtype=dtype), randn(k, n, dtype=dtype), \
                randn(m, n, dtype=dtype)
            got, want = G.dgemm(x, y), dgemm_ref(x, y)
            want_c = dgemm_update_ref_(c.clone(), x, y)
            G.dgemm_update_(c, x, y)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, **gemm_tol[dtype])
            torch.testing.assert_close(c, want_c, **gemm_tol[dtype])
    # strided views whose window starts off the 16-byte grid
    a = randn(1024, 1024)
    got, want = a.clone(), a.clone()
    for t, fn in ((got, G.dgemm_update_), (want, dgemm_update_ref_)):
        fn(t[131:, 131:], t[131:, 3:131], t[3:131, 131:])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **gemm_tol[torch.float32])
    print(f"[7] dgemm and dgemm_update_ vs plain: {GEMM_SWEEP} and ragged "
          f"{GEMM_RAGGED} in f32 (rtol 2e-5, atol 1e-3) and bf16 (0.1), "
          f"unaligned views of a 1024^2 matrix: all within tolerance")

    def step0(t, fn, split):
        """HPL's step-0 trailing update on views of the n x n matrix t:
        the main path's two calls (next panel, rest), or one."""
        l21, u12, a22 = t[HPL_NB:, :HPL_NB], t[:HPL_NB, HPL_NB:], \
            t[HPL_NB:, HPL_NB:]
        if split:
            fn(a22[:, :HPL_NB], l21, u12[:, :HPL_NB])
            fn(a22[:, HPL_NB:], l21, u12[:, HPL_NB:])
        else:
            fn(a22, l21, u12)

    a_big = randn(HPL_N, HPL_N)
    a_plain = a_big.clone()
    gemm_errs = []
    for split in (True, False):
        before = a_big[HPL_NB:, HPL_NB:].abs().sum()
        step0(a_big, G.dgemm_update_, split)
        step0(a_plain, dgemm_update_ref_, split)
        torch.cuda.synchronize()
        check(bool(a_big[HPL_NB:, HPL_NB:].abs().sum() != before),
              "the step-0 update changed the trailing window")
        torch.testing.assert_close(a_big, a_plain, **gemm_tol[torch.float32])
        gemm_errs.append(float((a_big - a_plain).abs().max()))
    err["dgemm"] = max(gemm_errs)
    del a_plain
    print(f"[7] HPL step-0 update at n={HPL_N}, nb={HPL_NB} (f32 views, "
          f"ld={HPL_N}): max|err| {gemm_errs[0]:.3e} (lookahead split), "
          f"{gemm_errs[1]:.3e} (one call)")

    # 8. the HPL path at full size
    torch.cuda.empty_cache()
    cfg = HPLConfig(n=HPL_N, block=HPL_NB, lookahead=HPL_LOOKAHEAD)
    steps = cfg.n // cfg.block
    # each step but the last updates the next panel; all but the last two
    # also update the rest
    expect = (steps - 1) + (steps - 2) if cfg.lookahead else steps - 1
    torch.cuda.synchronize()
    K.reset_launches()
    G.reset_launches()
    t0 = time.perf_counter()
    res = linpack_run(cfg)
    total = time.perf_counter() - t0
    hpl_launches = {**K.LAUNCHES, **G.LAUNCHES}
    print(f"[8] linpack_run(n={cfg.n}, block={cfg.block}, lookahead="
          f"{cfg.lookahead}): scaled residual {res.residual:.4e}, passed "
          f"{res.passed}, factorization {res.wall_s:.3f} s, "
          f"{res.gflops:.1f} GFLOP/s (2/3 n^3), {total:.2f} s in all; "
          f"launches {hpl_launches}")
    check(res.passed, "HPL scaled residual < 16")
    check(hpl_launches["dgemm"] == expect,
          f"dgemm launched {expect} times on the HPL path")
    check(hpl_launches["dslash_split"] == hpl_launches["dslash_eo_split"]
          == 0, "the HPL path launches no D-slash")
    del a_big
    torch.cuda.empty_cache()
    # one matrix on the CPU (plain) and on the card (kernel).  Seed 20's
    # closest pivot choice is a relative gap of 4.8e-4 (the widest of the
    # 60 seeds checked), above the rounding differences of two devices.
    # The factors are held normwise at 1e-3: on one CPU, the JAX package's
    # and the port's LU at n = 1024 differ by up to 1.0e-4 of max|lu| and
    # 2.9e-4 of max|x|, since the two sum in other orders.
    small = DEFAULT_HPL
    rng_small = np.random.default_rng(SMALL_HPL_SEED)
    a_c = convert.matrix_from_numpy(
        rng_small.standard_normal((small.n, small.n)), "cpu")
    b_c = torch.from_numpy(rng_small.standard_normal(small.n)
                           .astype(np.float32))
    r_cpu = blocked_lu(a_c, small.block, lookahead=small.lookahead)
    x_cpu = lu_solve(r_cpu, b_c, small.block)
    r_gpu = blocked_lu(a_c.to(dev), small.block, lookahead=small.lookahead)
    x_gpu = lu_solve(r_gpu, b_c.to(dev), small.block).cpu()
    dlu = float((r_gpu.lu.cpu() - r_cpu.lu).abs().max()
                / r_cpu.lu.abs().max())
    dx = float((x_gpu - x_cpu).abs().max() / x_cpu.abs().max())
    same_piv = torch.equal(r_gpu.piv.cpu(), r_cpu.piv)
    print(f"[8] n={small.n}, block={small.block}: CPU plain vs card kernel: "
          f"pivots equal {same_piv}, max|dlu|/max|lu| {dlu:.2e}, "
          f"max|dx|/max|x| {dx:.2e}")
    check(same_piv, "pivots equal on the CPU and the card")
    check(dlu <= 1e-3 and dx <= 1e-3, "LU and x agree to 1e-3 normwise")
    t0 = time.perf_counter()
    hpl_profile(blocked_lu, randn(HPL_PROFILE_N, HPL_PROFILE_N))
    print(f"[8] the profiled phase took {time.perf_counter() - t0:.1f} s")

    # 9. the time of step 0's larger update (the rest, after the next
    # panel's columns) at full size, on views of the n x n matrix
    a_big = randn(HPL_N, HPL_N)
    l21, u12, a22 = a_big[HPL_NB:, :HPL_NB], \
        a_big[:HPL_NB, 2 * HPL_NB:], a_big[HPL_NB:, 2 * HPL_NB:]
    ms = timed_ms(lambda: G.dgemm_update_(a22, l21, u12), reps=10, warmup=2)
    plain_ms = timed_ms(lambda: dgemm_update_ref_(a22, l21, u12), reps=3,
                        warmup=1)
    library_ms = timed_ms(lambda: a22.addmm_(l21, u12, alpha=-1), reps=10,
                          warmup=2)
    matmul_ms = timed_ms(lambda: torch.matmul(l21, u12), reps=10, warmup=2)
    m, n = a22.shape
    flops = 2 * m * n * HPL_NB
    b_ms, b_by = bound([l21, u12, a22, a22], flops, 1)
    print(f"[9] dgemm_update_ at ({m},{HPL_NB})@({HPL_NB},{n}): "
          f"{ms:.3f} ms, {flops / ms / 1e9:.2f} TFLOP/s, "
          f"{100 * b_ms / ms:.1f}% of the {b_ms:.3f} ms {b_by} bound; "
          f"plain (matmul, then sub_) {plain_ms:.3f} ms; library "
          f"a22.addmm_(l21, u12, alpha=-1) {library_ms:.3f} ms; "
          f"torch.matmul(l21, u12) alone {matmul_ms:.3f} ms (TF32 off)")
    records.append({"name": "dgemm", "route": "cuda", "source": GEMM_SOURCE,
                    "replaces": GEMM_REPLACES,
                    "launches": hpl_launches["dgemm"],
                    "max_abs_err": err["dgemm"], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": library_ms})

    print(f"[9] chip_smoke.py took {time.perf_counter() - t_start:.1f} s "
          f"in all")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
