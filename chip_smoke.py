#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

  python3 chip_smoke.py

Phases (one line each, or a few):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from the sources in this checkout;
  3. each kernel against its plain PyTorch version on the card, at the
     thermal lattice 32^3 x 8 (both even-odd source parities, and the full
     hop), rtol = atol = 1e-4;
  4. the main path: ``solve_dirac(U, b, 0.137, EO_MIXED_SOLVER)`` at 32^3 x 8
     on seeded right-hand sides, with the kernels' launch counts read
     around it; then a small lattice solved on the CPU (plain versions) and
     on the card (kernels), which must agree;
  5. ``solve_dirac(..., PLAIN_SOLVER)`` at 32^3 x 8;
  6. each kernel's time (CUDA events) beside its bound and its plain
     version's time.
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import numpy as np

    from repro_torch import convert
    from repro_torch.configs.lcsc_lqcd import (EO_MIXED_SOLVER, PLAIN_SOLVER,
                                               THERMAL_LATTICE)
    from repro_torch.kernels import _build
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
    _build.build(["dslash"])
    K._lib()
    print(f"[2] built {_build.library_path('dslash').name} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in _build.build_log("dslash").splitlines():
        if "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")

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

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
