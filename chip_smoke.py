#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

  python3 chip_smoke.py

Phases (one line each, or a few):
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels (four families, one nvcc each, in parallel)
     from the sources in this checkout; fail if ptxas reports spill bytes
     in any instantiation of the GEMM kernel or of the RMSNorm kernels;
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
     path's shapes (RMSNorm (8192, 1024) bf16 and (8192, 2048) f32 in
     prefill, (4, 1024) and (4, 2048) in decode, each with the kernel the
     library picks for it; one SSD chunk (4, 256, 32, 64, 128) with bf16
     x, B, C as views);
 11. the third path: serving mamba2-370m at its published widths
     (48 layers, seeded random weights): prefill of 4 x 2048 prompt tokens
     and 64 greedy decode steps through ``make_prefill_step``,
     ``grow_decode_cache`` and ``make_decode_step``, with exact launch
     counts (RMSNorm's by shape and by kernel variant too); then the
     model cut to 2 layers, prompt 300 (a ragged last chunk), on the CPU
     (plain versions) and on the card (kernels), which must pick the same
     greedy tokens over 8 steps;
 12. the new kernels' times beside their bounds, their plain versions'
     and the library's (``torch.nn.functional.rms_norm`` at RMSNorm's four
     path shapes, cold and warm, through ``kernels/rmsnorm/bench.py``;
     none computes an SSD chunk); the prefill's time and the
     decode rate; one prefill and 16 decode steps under torch.profiler
     (the device's busy share, its largest activities, the SSD-chunk and
     RMSNorm kernels' shares of the prefill's device time, its activities
     per decode step);
 13. energy: the card's watts (nvidia-smi's power.draw and SM clock every
     100 ms over 3 s) idle, under a loop of the thermal Schur normal op
     A^dagger A on the even-odd kernel (HBM-bound) and under a loop of
     HPL's step-0 update on the GEMM kernel (compute-bound), each beside
     the H100 table's constant; ``measured_lqcd_calibration`` at 32^3 x 8
     on the card; then ``cluster.run`` of the thermal EO_MIXED solve
     (``LQCDSolveWorkload`` with that calibration) and HPL at n = 32768
     (``HPLWorkload``) on the card, with exact launch counts and each
     result's joules held to its trace's integral; nvidia-smi samples the
     card's watts over that run;
 14. the T-sharded LQCD path, several shards on the one card (a
     ``lattice_mesh``): the sharded even-odd hop (B1 on halo-padded
     blocks) at 32^3 x 8 over 2 and 4 shards, both parities, equal bit
     for bit to the one-device hop, with one B1 launch per shard, and B1
     on one padded block against its plain version; ``dslash_sharded``
     (B2 on padded blocks) with and without compressed halos, equal to
     the one-device full hop; ``solve_dirac(..., EO_MIXED_SOLVER,
     mesh=lattice_mesh(64, 4))`` at 32^3 x 64 beside the one-device
     solve, and the same at 32^3 x 8 over 2 shards (converged, iterations
     within 2, x within 1e-3 of max|x|, B1 launches exact); at 32^3 x 64
     the sharded EO hop over 4 shards, both parities, equal bit for bit
     to the one-device hop, and B1 on shard 0's padded block, the
     one-device B1 and the one-device B2 against their plain versions,
     before those inputs are timed; the sharded
     hop's device time beside the one-device hop's; the calibration on
     4 shards beside the one-device one; a 8^3 x 16 sharded solve on the
     CPU (plain) against the card (B1).
Every time is taken by ``repro_torch.kernels.timing``: the calls are
queued behind a sleep kernel, and a kernel's or a library call's reading
that the host paced is taken again behind a longer sleep (a plain
version's is kept, the host's pace in it).  The line before the last is the
kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises: the script then
exits non-zero and prints no result.  It needs a CUDA device and the
``src/repro_torch`` package beside it.
"""
from __future__ import annotations

import copy
import json
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

KAPPA = 0.137
SEED = 0
N_RHS = 2
TOL = 1e-4                      # rtol = atol: tests/test_kernels.py sweep
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
WATT_LEAD_S, WATT_WINDOW_S = 1.0, 3.0   # see phase 13
WATT_QUERY = ["nvidia-smi", "--query-gpu=power.draw,clocks.sm",
              "--format=csv,noheader,nounits", "-lms", "100"]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def device_activity(fn):
    """Run ``fn()`` under torch.profiler; return its result, the wall
    seconds (host clock, synchronised), the device seconds and count of
    each device activity by name, and the names in the order they ran."""
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
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in device:
        busy[e.name] = busy.get(e.name, 0.0) + e.device_time_total / 1e6
        count[e.name] = count.get(e.name, 0) + 1
    order = [e.name for e in sorted(device, key=lambda e: e.time_range.start)]
    return out, wall, busy, count, order


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
    _, wall, busy, count, _ = device_activity(factor)
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


class PowerSamples:
    """``nvidia-smi`` sampling power.draw and the SM clock every 100 ms
    for as long as the ``with`` block runs; ``watts`` and ``clocks`` hold
    the samples afterwards.  A sampler that ends early or prints anything
    else fails the run."""

    def __enter__(self) -> "PowerSamples":
        self.smi = subprocess.Popen(WATT_QUERY, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc) -> None:
        alive = self.smi.poll() is None
        # SIGINT, as a Ctrl-C ends nvidia-smi's loop: it flushes its output
        self.smi.send_signal(signal.SIGINT)
        try:
            out, err = self.smi.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.smi.kill()
            out, err = self.smi.communicate(timeout=30)
        if exc[0] is not None:
            return
        check(alive, f"nvidia-smi sampled the whole window (exit "
                     f"{self.smi.returncode}: {err[:200]!r})")
        rows = [line.split(",") for line in out.strip().splitlines()]
        check(len(rows) >= 10 and all(len(r) == 2 for r in rows),
              f"nvidia-smi gave power.draw, clocks.sm samples: {out[:200]!r} "
              f"{err[:200]!r}")
        self.watts = [float(r[0]) for r in rows]
        self.clocks = [float(r[1]) for r in rows]

    @property
    def mean_w(self) -> float:
        return sum(self.watts) / len(self.watts)


def read_watts(fn=None) -> tuple[float, int, float, float]:
    """Run ``fn()`` in a loop (or leave the card idle) for WATT_LEAD_S,
    then for WATT_WINDOW_S more with ``nvidia-smi`` sampling beside it.
    Returns the mean watts, the sample count, the mean SM clock (MHz) and
    the calls per second in the window.  The host keeps at most two
    batches of 8 calls queued ahead of the card, so the card never drains
    between them."""
    import torch

    def loop(seconds: float) -> int:
        t0, n, marks = time.perf_counter(), 0, []
        while time.perf_counter() - t0 < seconds:
            if fn is None:
                time.sleep(0.01)
                continue
            fn()
            n += 1
            if n % 8 == 0:
                marks.append(torch.cuda.Event())
                marks[-1].record()
                if len(marks) > 2:
                    marks.pop(0).synchronize()
        return n

    torch.cuda.synchronize()
    loop(WATT_LEAD_S)
    with PowerSamples() as ps:
        t0 = time.perf_counter()
        rate = loop(WATT_WINDOW_S) / (time.perf_counter() - t0)
    torch.cuda.synchronize()
    return ps.mean_w, len(ps.watts), sum(ps.clocks) / len(ps.clocks), rate


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
    from repro_torch.cluster import HPLWorkload, LQCDSolveWorkload, run
    from repro_torch.config import full_config
    from repro_torch.configs.lcsc_lqcd import (EO_MIXED_SOLVER, PLAIN_SOLVER,
                                               THERMAL_LATTICE)
    from repro_torch.configs.hpl import DEFAULT_HPL, HPLConfig
    from repro_torch.hpl import blocked_lu, linpack_run, lu_solve
    from repro_torch.kernels import _build
    from repro_torch.kernels.timing import bound, timed_ms
    from repro_torch.kernels.dgemm import kernel as G
    from repro_torch.kernels.dgemm.ref import dgemm_ref, dgemm_update_ref_
    from repro_torch.kernels.dslash import kernel as K
    from repro_torch.kernels.dslash.ref import (dslash_eo_split_ref,
                                                dslash_split_ref, to_split)
    from repro_torch.kernels.rmsnorm import bench as RB
    from repro_torch.kernels.rmsnorm import kernel as RK
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_chunk import kernel as SK
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    from repro_torch.configs.lcsc_lqcd import COLD_LATTICE
    from repro_torch.distributed import lattice_mesh
    from repro_torch.lqcd import (ShardedWilsonEO, dslash,
                                  dslash_flops_per_site, dslash_half, eo_pack,
                                  measured_lqcd_calibration, pack_gauge,
                                  schur_matvec, solve_dirac, su3_project)
    from repro_torch.lqcd.eo import schur_matvec_dagger
    from repro_torch.lqcd.multichip import dslash_sharded
    from repro_torch.lqcd.su3 import random_field_and_source
    from repro_torch.power import model as PM
    from repro_torch.roofline import hw
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
    power_limit_w = float(smi.split(",")[-1].strip().split()[0])
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
    spills = []
    for family in families:
        func, spill = "", ""
        for line in _build.build_log(family).splitlines():
            if "Function properties for" in line:
                func = line.split("Function properties for")[-1].strip()
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                spill = m[0]
            if (m and ("gemm_kernel" in func or "rmsnorm_kernel" in func)
                    and (int(m[1]) or int(m[2]))):
                spills.append(f"{func}: {line.strip()}")
            if "registers" in line:
                # the kernel and its template arguments, as mangled
                name = re.sub(r"^_ZN?\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+", "",
                              func).split("EEv")[0]
                print(f"    ptxas ({family}) {name}: "
                      f"{line.split(':', 1)[-1].strip()}; {spill}")
    check(not spills, f"no spills in gemm_kernel or rmsnorm_kernel*: "
                      f"{spills}")

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
        plain_ms = timed_ms(plain, reps=5, warmup=2, host_paced_ok=True)
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
                        warmup=1, host_paced_ok=True)
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
    # and the gated norm (f32 x, bf16 scale over d_inner), B x S rows in
    # prefill and B rows in decode
    rms_shapes = RB.path_shapes(cfg.d_model, cfg.d_inner_ssm, cfg.n_layers,
                                SERVE_BATCH, SERVE_PROMPT, SERVE_GEN)
    rms_errs = RB.check_shapes({"kernel": RK.rmsnorm}, rms_shapes, SEED)
    err["rmsnorm"] = max(e["kernel"] for e in rms_errs.values())
    rms_variant = {k: RK.variant(randn(r, d, dtype=xdt),
                                 randn(d, dtype=wdt))[0]
                   for k, (r, d, xdt, wdt, _) in rms_shapes.items()}
    print(f"[10] rmsnorm vs plain: {RMS_SWEEP} in f32 (1e-5) and bf16 "
          f"(0.05) within tolerance; the path's shapes:")
    for k, (r, d, xdt, wdt, _) in rms_shapes.items():
        print(f"    {k} ({r}, {d}) x {xdt}, w {wdt}: kernel "
              f"{rms_variant[k]}, max|err| {rms_errs[k]['kernel']:.3e}")

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
    by_variant = RK.variant_launches()
    toks, cache, finite, t_pre, t_dec = serve(SERVE_GEN)
    lm_launches = {**K.LAUNCHES, **G.LAUNCHES, **RK.LAUNCHES, **SK.LAUNCHES}
    by_variant = {k: v - by_variant[k]
                  for k, v in RK.variant_launches().items()}
    by_shape = dict(RK.SHAPE_LAUNCHES)
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
    # the launches at each path shape, counted by the wrapper in this run
    rms_launches = {k: by_shape.get((r, d, xdt), 0)
                    for k, (r, d, xdt, _, _) in rms_shapes.items()}
    print(f"[11] rmsnorm launches by shape: {rms_launches} (want "
          f"{ {k: s[-1] for k, s in rms_shapes.items()} }); by kernel "
          f"variant: {by_variant}")
    check(all(n == rms_shapes[k][-1] for k, n in rms_launches.items())
          and sum(rms_launches.values()) == lm_launches["rmsnorm"],
          "rmsnorm launched at the path's four shapes only, each as often "
          "as the model's layers and steps say")
    want_variant = dict.fromkeys(RK.VARIANTS, 0)
    for k, n in rms_launches.items():
        want_variant[rms_variant[k]] += n
    check(by_variant == want_variant, "each RMSNorm of the serve path ran "
          "the kernel variant its shape picks")
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

    # 12. times: RMSNorm at its four path shapes, cold and warm, beside
    # the library; the share of the byte bound from the cold time
    rms_t = RB.time_shapes({"kernel": RK.rmsnorm, "library": RB.library},
                           rms_shapes, seed=SEED)
    rms_rec = {}
    for k, (r, d, xdt, wdt, _) in rms_shapes.items():
        t, n = rms_t[k], rms_launches[k]
        b_ms, b_by = t["bound_ms"], t["bound_by"]
        kc, kw = t["kernel"]["cold"], t["kernel"]["warm"]
        lc, lw = t["library"]["cold"], t["library"]["warm"]
        print(f"[12] rmsnorm {k} ({r}, {d}) x {xdt}, w {wdt}, "
              f"{rms_variant[k]}: cold {kc * 1e3:.2f} us "
              f"({100 * b_ms / kc:.1f}% of the {b_ms * 1e3:.3f} us {b_by} "
              f"bound; {t['sets']} sets), "
              f"warm {kw * 1e3:.2f} us; library F.rms_norm cold "
              f"{lc * 1e3:.2f} us ({100 * b_ms / lc:.1f}%), warm "
              f"{lw * 1e3:.2f} us; {n} launches in [11]'s serve run")
        check(b_ms <= kc and b_ms <= lc, f"rmsnorm {k}: cold times within "
              f"the byte bound (else the bound counts bytes wrongly)")
        rms_rec[k] = {"variant": rms_variant[k], "us_cold": kc * 1e3,
                      "us_warm": kw * 1e3, "library_us_cold": lc * 1e3,
                      "library_us_warm": lw * 1e3, "bound_us": b_ms * 1e3,
                      "bound_by": b_by, "launches": n}
    r, d, xdt, wdt, _ = rms_shapes["gated"]
    x, w = randn(r, d, dtype=xdt), randn(d, dtype=wdt)
    plain_ms = timed_ms(lambda: rmsnorm_ref(x, w), reps=10, warmup=2,
                        host_paced_ok=True)
    print(f"[12] rmsnorm plain version at the gated shape: "
          f"{plain_ms * 1e3:.1f} us")
    gated = rms_rec["gated"]
    records.append({"name": "rmsnorm", "route": "cuda", "source": RMS_SOURCE,
                    "replaces": RMS_REPLACES,
                    "launches": lm_launches["rmsnorm"],
                    "max_abs_err": err["rmsnorm"],
                    "ms": gated["us_warm"] / 1e3, "plain_ms": plain_ms,
                    "bound_ms": gated["bound_us"] / 1e3,
                    "bound_by": gated["bound_by"],
                    "library_ms": gated["library_us_warm"] / 1e3,
                    "shapes": rms_rec})
    del x, w
    Bb, Q, H, P, N = ssd_shape
    ms = timed_ms(lambda: SK.ssd_chunk(*ssd_args), reps=20, warmup=3)
    plain_ms = timed_ms(lambda: ssd_chunk_ref(*ssd_args), reps=5, warmup=1,
                        host_paced_ok=True)
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
          f"{full_square / hw.PEAK_F32_FLOPS * 1e6:.1f} us at the f32 rate; "
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
    del ssd_args, y, hn, yr, hr
    _, _, _, t_pre, t_dec = serve(SERVE_GEN)
    print(f"[12] serve, second call: prefill {SERVE_BATCH} x {SERVE_PROMPT} "
          f"{t_pre * 1e3:.1f} ms ({SERVE_BATCH * SERVE_PROMPT / t_pre:.0f} "
          f"tok/s); decode {SERVE_GEN} steps x {SERVE_BATCH} "
          f"{t_dec * 1e3:.1f} ms ({t_dec / SERVE_GEN * 1e3:.2f} ms per step, "
          f"{SERVE_GEN * SERVE_BATCH / t_dec:.1f} tok/s); the weights' "
          f"{n_params * 2 / 1e9:.3f} GB read once per step is "
          f"{n_params * 2 / hw.HBM_BW * 1e3:.3f} ms at "
          f"{hw.HBM_BW / 1e12:.2f} TB/s")
    (logits, cache), wall, busy, count, order = device_activity(
        lambda: prefill(params, batch))
    print_activity(f"prefill {SERVE_BATCH} x {SERVE_PROMPT}", wall, busy,
                   count)
    for what, key in (("the SSD-chunk kernel", "ssd_chunk_kernel"),
                      ("the RMSNorm kernels", "rmsnorm_kernel")):
        k_busy = sum(v for k, v in busy.items() if key in k)
        k_count = sum(v for k, v in count.items() if key in k)
        print(f"[12] {what} in that prefill: {k_busy * 1e3:.3f} ms in "
              f"{k_count} launches, {100 * k_busy / sum(busy.values()):.1f}% "
              f"of the device's busy time")
        for name in sorted(k for k in busy if key in k):
            print(f"    {count[name]} x {name[:110]}")
    # the prefill's norms in the order they ran: each layer's norm1 (bf16
    # x) and gated norm (f32 x), then final_norm (bf16 x); where the
    # profiler's list falls short of the wrapper's count, which is missing
    seen = ["norm1" if "rows<__nv_bfloat16" in n else "gated"
            for n in order if "rmsnorm_kernel" in n]
    path = ["norm1", "gated"] * cfg.n_layers + ["final_norm"]
    lacks = ""
    for i in range(len(path)):
        if seen == [k.replace("final_norm", "norm1")
                    for k in path[:i] + path[i + 1:]]:
            lacks = (f"; it lacks launch {i + 1}, {path[i]}"
                     + (f" of layer {i // 2}" if i < len(path) - 1 else ""))
            break
    print(f"[12] the profiler lists {len(seen)} of the prefill's "
          f"{len(path)} RMSNorm launches{lacks}")
    cache = grow_decode_cache(cfg, cache, SERVE_BATCH,
                              SERVE_PROMPT + PROFILE_DECODE_STEPS)
    tok = torch.argmax(logits[:, :V], -1)[:, None].to(torch.int32)

    def decode_steps():
        lg, c, t = logits, cache, tok
        for _ in range(PROFILE_DECODE_STEPS):
            lg, c = decode(params, t, c)
            t = torch.argmax(lg[:, :V], -1)[:, None].to(torch.int32)
        return t

    _, wall, busy, count, _ = device_activity(decode_steps)
    print_activity(f"{PROFILE_DECODE_STEPS} decode steps", wall, busy, count,
                   steps=PROFILE_DECODE_STEPS)

    # 13. energy: the card's watts, the LQCD calibration on the card, and
    # the LQCD and HPL workloads through cluster.run
    del cache, logits, params, batch
    torch.cuda.empty_cache()
    t13 = time.perf_counter()
    psi_e = eo_pack(psi, 0)

    def normal_op():
        schur_matvec_dagger(U_e, U_o, schur_matvec(U_e, U_o, psi_e, KAPPA),
                            KAPPA)

    a_big = randn(HPL_N, HPL_N)
    l21, u12, a22 = a_big[HPL_NB:, :HPL_NB], \
        a_big[:HPL_NB, 2 * HPL_NB:], a_big[HPL_NB:, 2 * HPL_NB:]
    table = {"idle": PM.H100_IDLE_W, "A^dagger A (HBM-bound)":
             PM.H100_MEM_BOUND_W, "step-0 GEMM (compute-bound)":
             PM.H100_COMPUTE_BOUND_W}
    loads = {"idle": None, "A^dagger A (HBM-bound)": normal_op,
             "step-0 GEMM (compute-bound)":
             lambda: G.dgemm_update_(a22, l21, u12)}
    op_flops = 2 * THERMAL_LATTICE.volume * dslash_flops_per_site()
    watts, rates = {}, {}
    for what, fn in loads.items():
        w, n, clock, rates[what] = read_watts(fn)
        watts[what] = w
        print(f"[13] {what}: {w:.2f} W mean of {n} samples, SM clock "
              f"{clock:.0f} MHz, {rates[what]:.1f} calls/s in the "
              f"{WATT_WINDOW_S:.0f} s window; {w / table[what]:.3f} x the "
              f"table's {table[what]:.2f} W ({PM.H100_MEASURED_ON})")
    w_idle, w_mem, w_gemm = watts.values()
    mem_rate = rates["A^dagger A (HBM-bound)"] * op_flops / 1e9
    check(w_idle < w_mem <= 1.05 * power_limit_w,
          f"idle {w_idle:.1f} W < HBM-bound {w_mem:.1f} W <= 1.05 x the "
          f"{power_limit_w} W limit")
    check(w_gemm <= 1.05 * power_limit_w,
          f"compute-bound {w_gemm:.1f} W <= 1.05 x the {power_limit_w} W "
          f"limit")
    del a_big, l21, u12, a22
    torch.cuda.empty_cache()

    K.reset_launches()
    reps = 5
    cal = measured_lqcd_calibration(THERMAL_LATTICE.shape, reps=reps,
                                    device="cuda")
    print(f"[13] measured_lqcd_calibration({THERMAL_LATTICE.shape}, "
          f"device='cuda'): {reps} A^dagger A in {cal.wall_s * 1e3:.3f} ms, "
          f"{cal.gflops:.1f} GFLOP/s, {cal.eff_bw_gbs:.1f} GB/s, busy "
          f"{cal.busy_w:.2f} W (the table's), {cal.gflops_per_w:.4f} "
          f"GFLOP/s/W; with the HBM-bound watts read above "
          f"{cal.gflops / w_mem:.4f} GFLOP/s/W; launches {dict(K.LAUNCHES)}."
          f"  The watts window's A^dagger A loop ran at {mem_rate:.1f} "
          f"GFLOP/s, {mem_rate / w_mem:.4f} GFLOP/s/W")
    check(K.LAUNCHES["dslash_eo_split"] == 4 * (reps + 1)
          and K.LAUNCHES["dslash_split"] == 0,
          "the calibration launched 4 EO hops per A^dagger A, warm-up "
          "included")
    check(cal.source == "measured" and cal.gflops > 0
          and abs(cal.energy_j - cal.busy_w * cal.wall_s)
          <= 1e-9 * cal.energy_j, "calibration joules = busy W x wall")

    hpl_cfg = HPLConfig(n=HPL_N, block=HPL_NB)
    steps = hpl_cfg.n // hpl_cfg.block
    for mod in (K, G):
        mod.reset_launches()
    t0 = time.perf_counter()
    with PowerSamples() as run_w:
        res = run([LQCDSolveWorkload(lattice=THERMAL_LATTICE,
                                     calibration=cal),
                   HPLWorkload(cfg=hpl_cfg)])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    e_launches = {**K.LAUNCHES, **G.LAUNCHES}
    lq, hpl = res.results
    it, outer = lq.details["iters"], lq.details["outer_iters"]
    want = {"dslash_eo_split": 4 * it + 4 * outer + 2, "dslash_split": 1,
            "dgemm": (steps - 1) + (steps - 2 if hpl_cfg.lookahead else 0)}
    for r in res.results:
        t_end = float(r.power_trace.t[-1])
        integral = r.power_trace.energy_j(t0=t_end - r.wall_s, t1=t_end)
        print(f"[13] {r.kind} at {r.details['op_f_mhz']:.0f} MHz "
              f"(its placement's point): {r.perf_gflops:.2f} GFLOP/s over "
              f"{r.wall_s:.6f} s, {r.energy_j:.4f} J, "
              f"{r.gflops_per_w:.4f} GFLOP/s/W; the trace's integral over "
              f"that window {integral:.4f} J")
        check(abs(r.energy_j - integral) <= 1e-9 * integral,
              f"{r.kind} joules = its trace's integral over its window")
    print(f"[13] the LQCD solve: {it} inner normal ops + {outer} outer, "
          f"rel. residual {lq.details['rel_residual']:.3e}, converged "
          f"{lq.details['converged']}; HPL scaled residual "
          f"{hpl.details['residual']:.4e}, passed {hpl.details['passed']}, "
          f"energy plan {float(hpl.power_trace.aux['freq_scale'][-1]):.3f} "
          f"x clock at {float(hpl.power_trace.components['chip'][-1]):.2f} "
          f"W; launches {e_launches} (want {want}); run() took {wall:.2f} s")
    print(f"[13] nvidia-smi over run(): {run_w.mean_w:.2f} W mean of "
          f"{len(run_w.watts)} samples (max {max(run_w.watts):.2f} W); HPL's "
          f"{hpl.perf_gflops:.2f} GFLOP/s at that draw is "
          f"{hpl.perf_gflops / run_w.mean_w:.4f} GFLOP/s/W (the plan's "
          f"watts give {hpl.gflops_per_w:.4f})")
    check(lq.details["converged"] and lq.details["rel_residual"] <= 1e-6,
          "the workload's solve converged")
    check(hpl.details["passed"], "the workload's HPL passed")
    check(e_launches == want, f"launch counts on the energy path {want}")
    l3 = res.efficiency(3)
    print(f"[13] the merged L-CSC trace ({res.schedule.topology.n_nodes} "
          f"nodes, modelled): makespan {res.makespan:.1f} s, L3 "
          f"{l3.mflops_per_w:.1f} MFLOPS/W at {l3.avg_power_w:.0f} W; "
          f"phase 13 took {time.perf_counter() - t13:.1f} s")

    # 14. the T-sharded path: several shards on the one card
    torch.cuda.empty_cache()
    t14 = time.perf_counter()
    card = f"{kind}, {power_limit_w:.2f} W"
    sharded = {"dslash_eo_split": {}}

    def hop_ms(fn):
        # 20 calls: a sharded hop over 4 shards is 24 launches, and with
        # 50 calls queued the card's launch queue (~1000 deep) blocked
        # the host before the sleep ended, in every retry
        return timed_ms(fn, reps=20, warmup=3)

    # 14a. the sharded EO hop against the one-device hop, bit for bit
    one_ms = hop_ms(lambda: K.dslash_eo_split(*eo_args))
    for n in (2, 4):
        mesh = lattice_mesh(lat[3], n)
        ops = ShardedWilsonEO(U_e, U_o, KAPPA, mesh)
        check(ops.backend == "kernel" and mesh.n == n
              and len(mesh.distinct_devices) == 1,
              f"{n} shards on the one card, on the kernel path")
        for src_parity in (0, 1):
            p = eo_pack(psi, src_parity)
            U_out, U_src = (U_o, U_e) if src_parity == 0 else (U_e, U_o)
            want = dslash_half(U_out, U_src, p, src_parity)
            K.reset_launches()
            got = ops.dslash_half(p, src_parity)
            n_launch = K.LAUNCHES["dslash_eo_split"]
            torch.cuda.synchronize()
            diff = float((got - want).abs().max())
            print(f"[14a] sharded EO hop at {lat} over {n} shards "
                  f"(T_local {lat[3] // n}, padded to {lat[3] // n + 2}), "
                  f"src parity {src_parity}: max|diff| vs the one-device "
                  f"B1 {diff:.1e}, {n_launch} B1 launches ({card})")
            check(torch.equal(got, want), "the sharded EO hop equals the "
                  "one-device hop bit for bit")
            check(n_launch == n, f"one B1 launch per shard ({n})")
        blocks = ops._split(eo_pack(psi, 0))
        ms = hop_ms(lambda: ops._hop(blocks, 0))
        sharded["dslash_eo_split"][f"{lat[3]}/{n}"] = ms
        print(f"[14a] sharded EO hop at {lat} over {n} shards: {ms * 1e3:.1f}"
              f" us device time per hop on per-shard blocks (halos, pads, "
              f"{n} B1 launches, crops), one-device B1 {one_ms * 1e3:.1f} us"
              f": {ms / one_ms:.3f} x ({card})")
    # B1 on one padded block (shard 0 of 4) against its plain version
    U_pad = ops._gauge
    idx = torch.tensor([lat[3] - 1, *range(ops.t_local + 1)], device=dev)
    pad_args = (to_split(U_pad[1][0]), to_split(U_pad[0][0]),
                to_split(eo_pack(psi, 0).index_select(3, idx).contiguous()),
                1)
    got = K.dslash_eo_split(*pad_args)
    want = dslash_eo_split_ref(*pad_args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    print(f"[14a] B1 on one padded block {tuple(pad_args[2].shape[:4])} vs "
          f"plain: max|err| {float((got - want).abs().max()):.3e} "
          f"(rtol=atol={TOL})")

    # 14b. the sharded full hop, compressed and not, against the one-device
    want = dslash(U, psi)
    for n in (2, 4):
        mesh = lattice_mesh(lat[3], n)
        K.reset_launches()
        c = dslash_sharded(U, psi, mesh, compress=True)
        u = dslash_sharded(U, psi, mesh, compress=False)
        n_launch = K.LAUNCHES["dslash_split"]
        torch.cuda.synchronize()
        print(f"[14b] dslash_sharded at {lat} over {n} shards: compressed vs "
              f"full halos max|diff| {float((c - u).abs().max()):.1e}, vs the "
              f"one-device B2 {float((c - want).abs().max()):.1e}; "
              f"{n_launch} B2 launches ({card})")
        check(torch.equal(c, u) and torch.equal(c, want),
              "the sharded full hop equals the one-device hop bit for bit, "
              "with and without compressed halos")
        check(n_launch == 2 * n, "one B2 launch per shard and call")
    del c, u, want

    # 14c. the sharded solve at full size beside the one-device solve
    def solve_pair(U_, b_, n):
        out = []
        for mesh in (None, lattice_mesh(U_.shape[4], n)):
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            res = solve_dirac(U_, b_, KAPPA, EO_MIXED_SOLVER, mesh=mesh)
            torch.cuda.synchronize()
            out.append((res, time.perf_counter() - t0, dict(K.LAUNCHES)))
        (one, w1, l1), (sh, w2, l2) = out
        shape = tuple(U_.shape[1:5])
        dx = float((sh.x - one.x).abs().max() / one.x.abs().max())
        for what, res, wall, lc, k in (("one device", one, w1, l1, 1),
                                       (f"{n} shards", sh, w2, l2, n)):
            print(f"[14c] EO_MIXED at {shape}, {what}: {res.iters} inner + "
                  f"{res.outer_iters} outer, true rel. residual "
                  f"{res.rel_residual:.3e}, {wall * 1e3:.1f} ms wall; "
                  f"launches {lc} ({card})")
            check(res.converged and res.rel_residual <= 1e-6,
                  f"the {what} solve at {shape} converged to <= 1e-6")
            check(lc["dslash_eo_split"] == k * (4 * res.iters
                                                + 4 * res.outer_iters + 1)
                  + 1 and lc["dslash_split"] == 1,
                  f"B1 launched per hop and shard in the {what} solve")
        print(f"[14c] {shape}: max|x_sharded - x_one| / max|x_one| {dx:.2e}")
        check(abs(sh.iters - one.iters) <= 2
              and abs(sh.outer_iters - one.outer_iters) <= 1,
              "sharded and one-device iterations within 2 (outer 1)")
        check(dx <= 1e-3, "sharded and one-device solutions within 1e-3")
        return sh, w1, w2, l2

    U_c, b_c = random_field_and_source(COLD_LATTICE.shape, SEED, dev)
    cold, w_one, w_sh, cold_l = solve_pair(U_c, b_c, 4)
    solve_pair(U, rhs[0], 2)
    # where the sharded solve's time goes: one more under torch.profiler
    for mesh in (None, lattice_mesh(64, 4)):
        _, wall, busy, count, _ = device_activity(
            lambda: solve_dirac(U_c, b_c, KAPPA, EO_MIXED_SOLVER, mesh=mesh))
        total, n_act = sum(busy.values()), sum(count.values())
        b1 = [sum(v for k, v in d.items() if "dslash_eo_kernel" in k)
              for d in (busy, count)]
        print(f"[14c] profiled EO_MIXED at {COLD_LATTICE.shape}, "
              f"{'one device' if mesh is None else '4 shards'}: "
              f"{wall * 1e3:.1f} ms wall, device busy {total * 1e3:.1f} ms "
              f"({100 * total / wall:.1f}%, idle {100 - 100 * total / wall:.1f}"
              f"%) in {n_act} device activities; B1 {b1[0] * 1e3:.1f} ms in "
              f"{b1[1]} launches ({card}); the largest others:")
        for name in sorted(busy, key=busy.get, reverse=True)[:4]:
            if "dslash_eo_kernel" not in name:
                print(f"    {busy[name] * 1e3:.3f} ms in {count[name]} x "
                      f"{name[:90]}")
    sharded["solve"] = {"lattice": list(COLD_LATTICE.shape), "shards": 4,
                        "ms_one_device": w_one * 1e3, "ms_sharded": w_sh * 1e3,
                        "iters": cold.iters, "outer_iters": cold.outer_iters,
                        "launches": cold_l}
    # the hops at 32^3 x 64 whose times follow, checked on the inputs the
    # timings reuse: the sharded EO hop over 4 shards (T_local 16, padded
    # to 18) equal to the one-device B1 bit for bit; B1 on shard 0's
    # padded block, the one-device B1 and the one-device B2 (the solve's
    # true residual) against their plain versions
    U_ce, U_co = pack_gauge(U_c)
    ops = ShardedWilsonEO(U_ce, U_co, KAPPA, lattice_mesh(64, 4))
    for src_parity in (0, 1):
        p = eo_pack(b_c, src_parity)
        U_out, U_src = (U_co, U_ce) if src_parity == 0 else (U_ce, U_co)
        want = dslash_half(U_out, U_src, p, src_parity)
        K.reset_launches()
        got = ops.dslash_half(p, src_parity)
        n_launch = K.LAUNCHES["dslash_eo_split"]
        torch.cuda.synchronize()
        print(f"[14c] sharded EO hop at {COLD_LATTICE.shape} over 4 shards "
              f"(T_local {ops.t_local}, padded to {ops.t_local + 2}), src "
              f"parity {src_parity}: max|diff| vs the one-device B1 "
              f"{float((got - want).abs().max()):.1e}, {n_launch} B1 "
              f"launches ({card})")
        check(torch.equal(got, want), "the sharded EO hop at 32^3 x 64 "
              "equals the one-device hop bit for bit")
        check(n_launch == 4, "one B1 launch per shard (4)")
    del p, got, want
    idx = torch.tensor([63, *range(ops.t_local + 1)], device=dev)
    cold_pad = (to_split(ops._gauge[1][0]), to_split(ops._gauge[0][0]),
                to_split(eo_pack(b_c, 0).index_select(3, idx).contiguous()),
                1)
    cold_args = (to_split(U_co), to_split(U_ce),
                 to_split(eo_pack(b_c, 0)), 0)
    full_args = (to_split(U_c), to_split(b_c))
    for what, fn, ref_fn, args, psi_s in (
            ("B1 on shard 0's padded block", K.dslash_eo_split,
             dslash_eo_split_ref, cold_pad, cold_pad[2]),
            ("one-device B1", K.dslash_eo_split, dslash_eo_split_ref,
             cold_args, cold_args[2]),
            ("one-device B2", K.dslash_split, dslash_split_ref, full_args,
             full_args[1])):
        got, want = fn(*args), ref_fn(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
        print(f"[14c] {what} {tuple(psi_s.shape[:4])} vs plain: max|err| "
              f"{err:.3e} (rtol=atol={TOL}) ({card})")
        del got, want
    del cold_pad, full_args, psi_s
    torch.cuda.empty_cache()
    # the hop's device time at 32^3 x 64, one device and over 4 shards
    one_cold = hop_ms(lambda: K.dslash_eo_split(*cold_args))
    b_ms, b_by = bound([cold_args[0], cold_args[1], cold_args[2],
                        cold_args[2]], cold_args[2].shape[:4].numel(),
                       dslash_flops_per_site())
    blocks = ops._split(eo_pack(b_c, 0))
    ms = hop_ms(lambda: ops._hop(blocks, 0))
    sharded["dslash_eo_split"]["64/4"] = ms
    print(f"[14c] EO hop at {COLD_LATTICE.shape}: one-device B1 "
          f"{one_cold * 1e3:.1f} us ({100 * b_ms / one_cold:.1f}% of the "
          f"{b_ms * 1e3:.1f} us {b_by} bound); over 4 shards "
          f"{ms * 1e3:.1f} us ({ms / one_cold:.3f} x; {100 * b_ms / ms:.1f}% "
          f"of the bound) ({card})")
    sharded["dslash_eo_split"]["64/1"] = one_cold
    del ops, blocks, U_c, b_c, U_ce, U_co, cold_args, cold
    torch.cuda.empty_cache()

    # 14d. the calibration over 4 shards on the one card
    cal_one = measured_lqcd_calibration(THERMAL_LATTICE.shape, reps=reps)
    K.reset_launches()
    cal_sh = measured_lqcd_calibration(THERMAL_LATTICE.shape, reps=reps,
                                       mesh=lattice_mesh(8, 4))
    print(f"[14d] measured_lqcd_calibration({THERMAL_LATTICE.shape}): "
          f"one device {cal_one.gflops:.1f} GFLOP/s, 4 shards "
          f"{cal_sh.gflops:.1f} GFLOP/s, ratio "
          f"{cal_sh.gflops / cal_one.gflops:.3f} (the cost of 4 shards on "
          f"one card: pad rows, halo copies, 4 x the launches; not a "
          f"multi-GPU loss); n_devices {cal_sh.n_devices}; launches "
          f"{dict(K.LAUNCHES)} ({card})")
    check(cal_sh.n_devices == 1, "4 shards on one card bill one device")
    check(K.LAUNCHES["dslash_eo_split"] == 4 * 4 * (reps + 1),
          "the sharded calibration launched 4 B1 per hop")

    # 14e. a sharded solve on the CPU (plain) against the card (B1)
    small = (8, 8, 8, 16)
    U_s8, b_s8 = gauge(small, "cpu"), spinor(small, "cpu")
    r_cpu = solve_dirac(U_s8, b_s8, KAPPA, EO_MIXED_SOLVER,
                        mesh=lattice_mesh(16, 4, devices=("cpu",)))
    K.reset_launches()
    r_gpu = solve_dirac(U_s8.to(dev), b_s8.to(dev), KAPPA, EO_MIXED_SOLVER,
                        mesh=lattice_mesh(16, 4))
    x_gpu = r_gpu.x.cpu()
    ok = torch.allclose(x_gpu, r_cpu.x, rtol=1e-3, atol=1e-4)
    print(f"[14e] {small} over 4 shards, CPU plain vs card B1: iters "
          f"{r_cpu.iters}+{r_cpu.outer_iters} vs {r_gpu.iters}+"
          f"{r_gpu.outer_iters}, max|dx| "
          f"{float((x_gpu - r_cpu.x).abs().max()):.2e}; card launches "
          f"{dict(K.LAUNCHES)}")
    check(r_cpu.converged and r_gpu.converged, "both sharded solves converged")
    check(abs(r_cpu.iters - r_gpu.iters) <= 2 and ok,
          "the sharded solve on the card agrees with the CPU's")
    for rec in records:
        if rec["name"] in ("dslash_eo_split", "dslash_split"):
            rec["sharded"] = {"launches_32x32x32x64_4_shards":
                              cold_l[rec["name"]]}
            if rec["name"] == "dslash_eo_split":
                rec["sharded"]["hop_ms_by_T_and_shards"] = \
                    sharded["dslash_eo_split"]
                rec["sharded"]["solve"] = sharded["solve"]
    print(f"[14] phase 14 took {time.perf_counter() - t14:.1f} s ({card})")

    print(f"[14] chip_smoke.py took {time.perf_counter() - t_start:.1f} s "
          f"in all")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
