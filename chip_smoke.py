#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

  python3 chip_smoke.py

Phases (one line each, or a few):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (four families, one nvcc each, in parallel)
     from the sources in this checkout; fail if ptxas reports spill bytes
     in any instantiation of the GEMM kernel;
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
     printed too);
 10. the RMSNorm and SSD-chunk kernels against their plain versions on the
     card: the JAX sweeps' shapes at their tolerances, and the serve
     path's shapes (RMSNorm (8192, 1024) bf16 and (8192, 2048) f32; one
     SSD chunk (4, 256, 32, 64, 128) with bf16 x, B, C as views);
 11. the third path: serving mamba2-370m at its published widths
     (48 layers, seeded random weights): prefill of 4 x 2048 prompt tokens
     and 64 greedy decode steps through ``make_prefill_step``,
     ``grow_decode_cache`` and ``make_decode_step``, with exact launch
     counts; then the model cut to 2 layers, prompt 300 (a ragged last
     chunk), on the CPU (plain versions) and on the card (kernels), which
     must pick the same greedy tokens over 8 steps;
 12. the new kernels' times beside their bounds, their plain versions'
     and the library's (``torch.nn.functional.rms_norm``; none computes an
     SSD chunk); the prefill's time and the decode rate; one prefill and
     16 decode steps under torch.profiler (the device's busy share, its
     largest activities, the SSD-chunk kernel's share of the prefill's
     device time, its activities per decode step).
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises: the script then
exits non-zero and prints no result.  It needs a CUDA device and the
``src/repro_torch`` package beside it.
"""
from __future__ import annotations

import copy
import json
import re
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
BF16_TC_FLOP_PER_S = 989e12     # H100 SXM data sheet, bf16 dense tensor cores
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
RMS_SOURCE = "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu"
RMS_REPLACES = "src/repro/kernels/rmsnorm/kernel.py:23"
SSD_SOURCE = "src/repro_torch/kernels/ssd_chunk/csrc/ssd_chunk.cu"
SSD_REPLACES = "src/repro/kernels/ssd_chunk/kernel.py:43"
# tests/test_kernels.py::test_rmsnorm_sweep and
# tests/test_kernels_extra.py::test_ssd_chunk_sweep
RMS_SWEEP = [(64, 128), (256, 512), (132, 256)]
SSD_SWEEP = [(2, 16, 3, 8, 4), (1, 32, 2, 16, 8), (3, 8, 4, 4, 16)]
ARCH = "mamba2-370m"
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 2048, 64
CUT_LAYERS, CUT_PROMPT, CUT_STEPS = 2, 300, 8
CUT_SEED = 37                   # see phase 11
# measured 0.0156 (one bf16 ulp at the logits' size, max|logit| 4.06) on
# an NVIDIA H100 80GB HBM3; held at two ulps of the largest logit
CUT_LOGIT_TOL = 0.0625
PROFILE_DECODE_STEPS = 16


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def timed_ms(fn, reps: int, warmup: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events.
    The calls are queued behind a ~25 ms sleep kernel, so that the host's
    launch overhead (tens of microseconds per ctypes launch) does not pace
    a kernel shorter than it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(in_out, sites: int, flops_per_site: int,
          bf16_tc_flops: int = 0) -> tuple[float, str]:
    """Least time (ms) for the work: each input read once and the output
    written once at the HBM rate, or the flops at the f32 rate plus
    ``bf16_tc_flops`` (bf16 operands, f32 sums: exact on the tensor cores)
    at the bf16 tensor-core rate."""
    nbytes = sum(t.numel() * t.element_size() for t in in_out)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (sites * flops_per_site / F32_FLOP_PER_S
             + bf16_tc_flops / BF16_TC_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def device_activity(fn):
    """Run ``fn()`` under torch.profiler; return its result, the wall
    seconds (host clock, synchronised), and the device seconds and count
    of each device activity by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, count = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.name] = busy.get(e.name, 0.0) + e.device_time_total / 1e6
            count[e.name] = count.get(e.name, 0) + 1
    return out, wall, busy, count


def hpl_profile(blocked_lu, a) -> None:
    """Factor ``a`` once plain and once under torch.profiler; print the
    wall times, the device's busy time by kernel and its idle share."""
    import torch
    n = a.shape[0]

    def factor() -> None:
        blocked_lu(a, HPL_NB, lookahead=HPL_LOOKAHEAD)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    factor()
    torch.cuda.synchronize()
    plain = time.perf_counter() - t0
    _, wall, busy, count = device_activity(factor)
    gemm = [0.0, 0]
    for name in [k for k in busy if "gemm_kernel" in k]:
        gemm[0] += busy.pop(name)
        gemm[1] += count.pop(name)
    total = sum(busy.values()) + gemm[0]
    print(f"[8] where the time goes, blocked_lu at n={n}, nb={HPL_NB}: "
          f"{plain:.3f} s plain, {wall:.3f} s under the profiler; "
          f"device busy {total:.3f} s ({100 * total / wall:.1f}% of the "
          f"profiled wall, idle {100 - 100 * total / wall:.1f}%): the "
          f"GEMM kernel {gemm[0]:.4f} s in {gemm[1]} launches, the rest "
          f"{total - gemm[0]:.4f} s in {sum(count.values())} device "
          f"activities ({sum(count.values()) / n:.1f} per column); the "
          f"largest of those:")
    for name in sorted(busy, key=busy.get, reverse=True)[:5]:
        print(f"    {busy[name]:.4f} s in {count[name]} x {name[:90]}")


def print_activity(what: str, wall: float, busy: dict, count: dict,
                   steps: int = 0) -> None:
    total, n = sum(busy.values()), sum(count.values())
    per = f", {n / steps:.1f} per step" if steps else ""
    print(f"[12] profiled {what}: {wall * 1e3:.2f} ms wall, device busy "
          f"{total * 1e3:.2f} ms ({100 * total / wall:.1f}%, idle "
          f"{100 - 100 * total / wall:.1f}%) in {n} device activities{per}; "
          f"the largest:")
    for name in sorted(busy, key=busy.get, reverse=True)[:5]:
        print(f"    {busy[name] * 1e3:.3f} ms in {count[name]} x "
              f"{name[:90]}")


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    import dataclasses

    from repro_torch import convert
    from repro_torch.config import full_config
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
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    from repro_torch.lqcd import (dslash_flops_per_site, eo_pack, pack_gauge,
                                  solve_dirac, su3_project)
    from repro_torch.models import init_params
    from repro_torch.runtime.steps import (grow_decode_cache,
                                           make_decode_step,
                                           make_prefill_step)

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
    families = ("dslash", "dgemm", "rmsnorm", "ssd_chunk")
    t0 = time.perf_counter()
    _build.build(families)
    for mod in (K, G, RK, SK):
        mod._lib()
    print(f"[2] built "
          f"{', '.join(_build.library_path(f).name for f in families)} in "
          f"{time.perf_counter() - t0:.2f} s")
    gemm_spills = []
    for family in families:
        func = ""
        for line in _build.build_log(family).splitlines():
            if "Function properties for" in line:
                func = line.split("Function properties for")[-1].strip()
            if "registers" in line or "spill" in line:
                print(f"    ptxas ({family}): {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and "gemm_kernel" in func and (int(m[1]) or int(m[2])):
                gemm_spills.append(f"{func}: {line.strip()}")
    check(not gemm_spills, f"no spills in gemm_kernel: {gemm_spills}")

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


    # 10. the LM kernels against their plain versions on the card
    del a_big, l21, u12, a22
    torch.cuda.empty_cache()
    cfg = full_config(ARCH)
    bf16 = torch.bfloat16
    rms_tol = {torch.float32: 1e-5, bf16: 0.05}
    for rows, d in RMS_SWEEP:
        for dtype in (torch.float32, bf16):
            x, w = randn(rows, d, dtype=dtype), randn(d, dtype=dtype)
            got, want = RK.rmsnorm(x, w), rmsnorm_ref(x, w)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=rms_tol[dtype],
                                       atol=rms_tol[dtype])
    # the path's shapes: the layer norms (bf16 x and scale over d_model)
    # and the gated norm (f32 x, bf16 scale over d_inner), B x S rows
    rows = SERVE_BATCH * SERVE_PROMPT
    rms_path = {
        "norm1": (randn(rows, cfg.d_model, dtype=bf16),
                  randn(cfg.d_model, dtype=bf16)),
        "gated": (randn(rows, cfg.d_inner_ssm),
                  randn(cfg.d_inner_ssm, dtype=bf16))}
    rms_errs = {}
    for k, (x, w) in rms_path.items():
        got, want = RK.rmsnorm(x, w), rmsnorm_ref(x, w)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=rms_tol[x.dtype],
                                   atol=rms_tol[x.dtype])
        rms_errs[k] = float((got.float() - want.float()).abs().max())
    err["rmsnorm"] = max(rms_errs.values())
    print(f"[10] rmsnorm vs plain: {RMS_SWEEP} in f32 (1e-5) and bf16 "
          f"(0.05) within tolerance; the path's ({rows}, {cfg.d_model}) "
          f"bf16 max|err| {rms_errs['norm1']:.3e}, ({rows}, "
          f"{cfg.d_inner_ssm}) f32 x, bf16 scale max|err| "
          f"{rms_errs['gated']:.3e}")

    def ssd_inputs(B, Q, H, P, N, dtype, views=False):
        """test_ssd_chunk_sweep's distributions; with ``views``, x, B and
        C are slices of one conv output and dt a slice of a longer
        sequence, as the model passes them."""
        x, bm, cm = randn(B, Q, H * P), randn(B, Q, N), randn(B, Q, N)
        dt = torch.nn.functional.softplus(randn(B, 2 * Q, H))
        A, h = -torch.exp(randn(H) * 0.3), randn(B, H, P, N)
        conv = torch.cat([x, bm, cm], -1).to(dtype)
        if not views:
            conv = conv.clone()
            return (conv[..., :H * P].reshape(B, Q, H, P).contiguous(),
                    dt[:, :Q].contiguous(), A,
                    conv[..., H * P:H * P + N].contiguous(),
                    conv[..., H * P + N:].contiguous(), h)
        return (conv[..., :H * P].reshape(B, Q, H, P), dt[:, Q:], A,
                conv[..., H * P:H * P + N], conv[..., H * P + N:], h)

    for shape in SSD_SWEEP:
        for dtype in (torch.float32, bf16):
            args = ssd_inputs(*shape, dtype)
            (y, hn), (yr, hr) = SK.ssd_chunk(*args), ssd_chunk_ref(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(y, yr, rtol=TOL, atol=TOL)
            torch.testing.assert_close(hn, hr, rtol=TOL, atol=TOL)
    sc = cfg.ssm
    ssd_shape = (SERVE_BATCH, sc.chunk_size, cfg.n_ssm_heads, sc.head_dim,
                 sc.d_state)
    # the wrapper's copy of the kernel's tiles and limits against the
    # library's own (the path's chunk, a long admitted one, refused ones)
    for qpn in (ssd_shape[1:2] + ssd_shape[3:], (4000, 128, 256),
                (8000, 128, 256), (30000, 8, 4), (16, 129, 4), (16, 8, 257)):
        for dtype in (torch.float32, bf16):
            check(SK.library_smem_bytes(*qpn, dtype)
                  == SK.admitted_smem_bytes(*qpn, dtype),
                  f"ssd_chunk shared memory and limits at (Q, P, N) = {qpn}, "
                  f"{dtype} agree with the library")
    ssd_args = ssd_inputs(*ssd_shape, bf16, views=True)
    (y, hn), (yr, hr) = SK.ssd_chunk(*ssd_args), ssd_chunk_ref(*ssd_args)
    torch.cuda.synchronize()
    # at Q = 256, N = 128 the f32 sums themselves are off an f64
    # evaluation by up to 6.6e-6 of max|y| (the plain version, CPU, same
    # distributions), so the absolute tolerance scales with max|y|
    for got, want in ((y, yr), (hn, hr)):
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=TOL, atol=1e-5 * scale)
    err["ssd_chunk"] = max(float((y - yr).abs().max()),
                           float((hn - hr).abs().max()))
    print(f"[10] ssd_chunk vs plain: {SSD_SWEEP} in f32 and bf16 within "
          f"rtol = atol = {TOL}; the path's {ssd_shape} (bf16 x, B, C as "
          f"views): max|dy| {float((y - yr).abs().max()):.3e} of max|y| "
          f"{float(yr.abs().max()):.1f}, max|dh| "
          f"{float((hn - hr).abs().max()):.3e} of max|h| "
          f"{float(hr.abs().max()):.2f} (rtol {TOL}, atol 1e-5 max|.|)")

    # 11. the third path: serving mamba2-370m at its published widths
    V = cfg.vocab_size
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[11] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_ssm_heads} heads of {sc.head_dim}, d_state {sc.d_state}, "
          f"chunk {sc.chunk_size}, vocab {V} (padded {cfg.vocab_padded}), "
          f"{cfg.dtype}; {n_params} parameter elements "
          f"(param_count() {cfg.param_count()}), initialised in "
          f"{time.perf_counter() - t0:.2f} s")
    prompt = np.random.default_rng(SEED).integers(
        0, V, (SERVE_BATCH, SERVE_PROMPT))
    batch = {"tokens": torch.from_numpy(prompt).to(dev, torch.int32)}
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)

    def serve(gen):
        """Prefill, then ``gen`` greedy steps, as launch.serve does."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        cache = grow_decode_cache(cfg, cache, SERVE_BATCH,
                                  SERVE_PROMPT + gen)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        finite = torch.isfinite(logits).all()
        shape_ok = tuple(logits.shape) == (SERVE_BATCH, cfg.vocab_padded)
        toks = [torch.argmax(logits[:, :V], -1)[:, None]]
        t0 = time.perf_counter()
        for _ in range(gen):
            logits, cache = decode(params, toks[-1].to(torch.int32), cache)
            finite &= torch.isfinite(logits).all()
            toks.append(torch.argmax(logits[:, :V], -1)[:, None])
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        return (torch.cat(toks, 1), cache, bool(finite) and shape_ok,
                t_pre, t_dec)

    torch.cuda.synchronize()
    for mod in (K, G, RK, SK):
        mod.reset_launches()
    toks, cache, finite, t_pre, t_dec = serve(SERVE_GEN)
    lm_launches = {**K.LAUNCHES, **G.LAUNCHES, **RK.LAUNCHES, **SK.LAUNCHES}
    L = cfg.n_layers
    want_rms = (2 * L + 1) * (1 + SERVE_GEN)
    want_ssd = L * -(-SERVE_PROMPT // sc.chunk_size)
    print(f"[11] served {SERVE_BATCH} x {SERVE_PROMPT} prompt tokens, then "
          f"{SERVE_GEN} greedy steps (first call): prefill {t_pre * 1e3:.1f}"
          f" ms, decode {t_dec * 1e3:.1f} ms ({SERVE_GEN * SERVE_BATCH / t_dec:.1f}"
          f" tok/s); launches {lm_launches} (want rmsnorm {want_rms}, "
          f"ssd_chunk {want_ssd}); sample {toks[0, :16].tolist()}")
    check(finite, "logits finite, of shape (B, vocab_padded), every step")
    check(bool((toks < V).all()), f"greedy tokens < {V}")
    check(int(cache["pos"]) == SERVE_PROMPT + SERVE_GEN,
          f"pos == {SERVE_PROMPT + SERVE_GEN}")
    check(tuple(cache["ssm"].shape) == (L, SERVE_BATCH) + ssd_shape[2:]
          and cache["ssm"].dtype == torch.float32, "ssm cache layout")
    check(lm_launches["rmsnorm"] == want_rms,
          f"rmsnorm launched {want_rms} times (97 per forward)")
    check(lm_launches["ssd_chunk"] == want_ssd,
          f"ssd_chunk launched {want_ssd} times")
    check(lm_launches["dslash_split"] == lm_launches["dslash_eo_split"]
          == lm_launches["dgemm"] == 0, "the serve path launches no "
          "D-slash and no GEMM kernel")
    del cache

    # the model cut to 2 layers at full width, on the CPU (plain versions)
    # and on the card (kernels).  Seed 37's narrowest greedy choice (batch
    # 1, 9 choices) is a top-2 logit gap of 0.125 on the CPU, 4 bf16 ulps
    # at the logits' size (the widest of seeds 0-399, with 240, 244 and
    # 396; most seeds have a choice within one ulp, which rounding on
    # another device may flip).
    cut = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    p_cpu = init_params(cut, torch.Generator().manual_seed(CUT_SEED), "cpu")
    p_gpu = copy.deepcopy(p_cpu).to(dev)
    cut_prompt = torch.from_numpy(np.random.default_rng(CUT_SEED).integers(
        0, V, (1, CUT_PROMPT)))
    cut_prefill, cut_decode = make_prefill_step(cut), make_decode_step(cut)

    def greedy(p, tokens):
        logits, cache = cut_prefill(p, {"tokens": tokens})
        first, toks, gaps = logits, [], []
        for k in range(CUT_STEPS + 1):
            top = torch.topk(logits[:, :V].float(), 2, -1).values
            gaps.append(float((top[:, 0] - top[:, 1]).min()))
            toks.append(torch.argmax(logits[:, :V], -1)[:, None])
            if k < CUT_STEPS:
                logits, cache = cut_decode(p, toks[-1], cache)
        return (first[:, :V].float().cpu(), torch.cat(toks, 1).cpu(),
                min(gaps))

    first_c, toks_c, gap_c = greedy(p_cpu, cut_prompt)
    for mod in (RK, SK):
        mod.reset_launches()
    first_g, toks_g, gap_g = greedy(p_gpu, cut_prompt.to(dev))
    dlogit = float((first_g - first_c).abs().max())
    print(f"[11] {CUT_LAYERS} layers at full width, prompt {CUT_PROMPT}: "
          f"CPU plain vs card kernels: max|dlogits| after prefill "
          f"{dlogit:.4f} (of max|logit| {float(first_c.abs().max()):.3f}); "
          f"greedy tokens {toks_c[0].tolist()} (CPU) and "
          f"{toks_g[0].tolist()} (card); narrowest top-2 gap "
          f"{gap_c:.4f} (CPU), {gap_g:.4f} (card); card launches "
          f"{dict(RK.LAUNCHES)}, {dict(SK.LAUNCHES)}")
    check(RK.LAUNCHES["rmsnorm"] == (2 * CUT_LAYERS + 1) * (CUT_STEPS + 1)
          and SK.LAUNCHES["ssd_chunk"]
          == CUT_LAYERS * -(-CUT_PROMPT // sc.chunk_size),
          "the cut model on the card went through both kernels")
    check(torch.equal(toks_c, toks_g), "same greedy tokens on CPU and card")
    check(dlogit <= CUT_LOGIT_TOL,
          f"prefill logits agree within {CUT_LOGIT_TOL}")
    del p_gpu

    # 12. times
    x, w = rms_path["gated"]
    w32 = w.float()
    rms_ms = {k: timed_ms(lambda: RK.rmsnorm(*a), reps=50, warmup=5)
              for k, a in rms_path.items()}
    plain_ms = timed_ms(lambda: rmsnorm_ref(x, w), reps=10, warmup=2)
    library_ms = timed_ms(lambda: torch.nn.functional.rms_norm(
        x, (x.shape[1],), w32, eps=1e-6), reps=50, warmup=5)
    b_ms, b_by = bound([x, w, x], x.numel(), 4)
    xn, wn = rms_path["norm1"]
    bn_ms, _ = bound([xn, wn, xn], xn.numel(), 4)
    print(f"[12] rmsnorm ({rows}, {x.shape[1]}) f32 x, bf16 scale (the "
          f"gated norm): {rms_ms['gated'] * 1e3:.1f} us, "
          f"{100 * b_ms / rms_ms['gated']:.1f}% of the {b_ms * 1e3:.1f} us "
          f"{b_by} bound; plain {plain_ms * 1e3:.1f} us; library "
          f"F.rms_norm {library_ms * 1e3:.1f} us.  ({rows}, {xn.shape[1]}) "
          f"bf16 (norm1, final_norm): {rms_ms['norm1'] * 1e3:.1f} us, "
          f"{100 * bn_ms / rms_ms['norm1']:.1f}% of {bn_ms * 1e3:.1f} us")
    records.append({"name": "rmsnorm", "route": "cuda", "source": RMS_SOURCE,
                    "replaces": RMS_REPLACES,
                    "launches": lm_launches["rmsnorm"],
                    "max_abs_err": err["rmsnorm"], "ms": rms_ms["gated"],
                    "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": library_ms})
    Bb, Q, H, P, N = ssd_shape
    ms = timed_ms(lambda: SK.ssd_chunk(*ssd_args), reps=20, warmup=3)
    plain_ms = timed_ms(lambda: ssd_chunk_ref(*ssd_args), reps=5, warmup=1)
    # the flops the function needs: the lower triangle (diagonal included)
    # of C B^T once per batch row (one group), exact on the bf16 tensor
    # cores when B and C are bf16; per (b, h) the lower triangle of the
    # scores times x and the two state terms, C h^T and x^T (B e^(..) dt),
    # whose f32 operands need the f32 rate
    cbt = Bb * Q * (Q + 1) * N
    per_head = Q * (Q + 1) * P + 4 * Q * P * N
    on_tc = ssd_args[3].dtype == bf16
    b_ms, b_by = bound(list(ssd_args) + [y, hn], 1,
                       Bb * H * per_head + (0 if on_tc else cbt),
                       bf16_tc_flops=cbt if on_tc else 0)
    needed = Bb * H * per_head + cbt
    full_square = Bb * H * (2 * Q * Q * N + 2 * Q * Q * P + 4 * Q * P * N)
    # with bf16 x, B and C the kernel runs each f32 product as three exact
    # bf16 products on the tensor cores: the least time for that work,
    # floored by the bytes, is the second bound; the share is taken
    # against the smaller of the two
    b2_ms, b2_by = bound(list(ssd_args) + [y, hn], 0, 0,
                         bf16_tc_flops=3 * Bb * H * per_head + cbt)
    print(f"[12] ssd_chunk {ssd_shape}: {ms * 1e3:.1f} us, "
          f"{needed / ms / 1e9:.2f} TFLOP/s of the {needed / 1e9:.3f} GFLOP "
          f"needed (C B^T {cbt / 1e9:.3f} GFLOP at the "
          f"{'bf16 tensor-core' if on_tc else 'f32'} rate, the rest "
          f"{Bb * H * per_head / 1e9:.3f} GFLOP at the f32 rate): "
          f"{100 * b_ms / ms:.1f}% of that {b_ms * 1e3:.1f} us {b_by} "
          f"bound; each f32 product as 3 bf16 tensor-core products "
          f"({(3 * Bb * H * per_head + cbt) / 1e9:.3f} GFLOP at 989 "
          f"TFLOP/s): {100 * b2_ms / ms:.1f}% of that {b2_ms * 1e3:.1f} us "
          f"{b2_by} bound; the TPU kernel's per-head full-square count "
          f"{full_square / 1e9:.3f} GFLOP would be "
          f"{full_square / F32_FLOP_PER_S * 1e6:.1f} us at the f32 rate; "
          f"plain {plain_ms:.3f} ms; library_ms: n/a (no PyTorch call "
          f"computes an SSD chunk)")
    if b2_ms < b_ms:
        b_ms, b_by = b2_ms, b2_by
    records.append({"name": "ssd_chunk", "route": "cuda",
                    "source": SSD_SOURCE, "replaces": SSD_REPLACES,
                    "launches": lm_launches["ssd_chunk"],
                    "max_abs_err": err["ssd_chunk"], "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": None})
    del rms_path, ssd_args, y, hn, yr, hr
    _, _, _, t_pre, t_dec = serve(SERVE_GEN)
    print(f"[12] serve, second call: prefill {SERVE_BATCH} x {SERVE_PROMPT} "
          f"{t_pre * 1e3:.1f} ms ({SERVE_BATCH * SERVE_PROMPT / t_pre:.0f} "
          f"tok/s); decode {SERVE_GEN} steps x {SERVE_BATCH} "
          f"{t_dec * 1e3:.1f} ms ({t_dec / SERVE_GEN * 1e3:.2f} ms per step, "
          f"{SERVE_GEN * SERVE_BATCH / t_dec:.1f} tok/s); the weights' "
          f"{n_params * 2 / 1e9:.3f} GB read once per step is "
          f"{n_params * 2 / HBM_BYTES_PER_S * 1e3:.3f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s")
    (logits, cache), wall, busy, count = device_activity(
        lambda: prefill(params, batch))
    print_activity(f"prefill {SERVE_BATCH} x {SERVE_PROMPT}", wall, busy,
                   count)
    ssd_busy = sum(v for k, v in busy.items() if "ssd_chunk_kernel" in k)
    ssd_count = sum(v for k, v in count.items() if "ssd_chunk_kernel" in k)
    share = 100 * ssd_busy / sum(busy.values())
    print(f"[12] the SSD-chunk kernel in that prefill: {ssd_busy * 1e3:.3f} "
          f"ms in {ssd_count} launches, {share:.1f}% of the device's busy "
          f"time")
    cache = grow_decode_cache(cfg, cache, SERVE_BATCH,
                              SERVE_PROMPT + PROFILE_DECODE_STEPS)
    tok = torch.argmax(logits[:, :V], -1)[:, None].to(torch.int32)

    def decode_steps():
        lg, c, t = logits, cache, tok
        for _ in range(PROFILE_DECODE_STEPS):
            lg, c = decode(params, t, c)
            t = torch.argmax(lg[:, :V], -1)[:, None].to(torch.int32)
        return t

    _, wall, busy, count = device_activity(decode_steps)
    print_activity(f"{PROFILE_DECODE_STEPS} decode steps", wall, busy, count,
                   steps=PROFILE_DECODE_STEPS)

    print(f"[12] chip_smoke.py took {time.perf_counter() - t_start:.1f} s "
          f"in all")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
