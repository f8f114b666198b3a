"""Time the CUDA RMSNorm at the serve path's four shapes, cold and warm,
beside ``torch.nn.functional.rms_norm`` (a yardstick: the port never
calls it) and beside ``x.clone()`` (a copy that moves the same bytes and
computes nothing: what the memory system gives a kernel of this size),
all timed in turns (the order reversed every other round)::

  python -m repro_torch.kernels.rmsnorm.bench

Needs a CUDA device.  ``chip_smoke.py`` phase [12] times the kernel and
the library through ``time_shapes``.  The script uses nothing of the
wrapper but ``kernel.rmsnorm``, so it also times another design of the
kernel: run it on a copy of the tree whose ``kernel.py`` and ``csrc/``
hold that design.

Warm: the same buffers in every call.  Cold: the calls walk through
distinct ``(x, w)`` sets whose x together exceed twice the L2 cache (at
most ``MAX_SETS`` of them, read after a read of twice the L2), and each
call's output stays alive until its set comes round again, so no call
finds its x, or the address it writes, in the L2.  Both queue their
calls behind a sleep kernel long enough to cover the host's launches
(``kernels/timing.py``).
"""
from __future__ import annotations

import math
import subprocess

import torch

from repro_torch.kernels import timing
from repro_torch.kernels.rmsnorm import kernel as K
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

EPS = 1e-6
WARM_REPS = 50
COLD_CALLS = 24                 # at least this many timed cold calls
MAX_SETS = 256                  # cold sets at the decode shapes
FLOPS_PER_ELEMENT = 4           # square, sum, scale by rsqrt, scale by w
TOL = {torch.float32: 1e-5, torch.bfloat16: 0.05}   # the JAX sweep's


def path_shapes(d_model: int, d_inner: int, n_layers: int, batch: int,
                prompt: int, gen: int) -> dict:
    """The serve path's RMSNorm shapes: name -> (rows, d, x dtype, w dtype,
    the launches that one prefill and ``gen`` decode steps should make)."""
    bf16, f32 = torch.bfloat16, torch.float32
    norms, gated = n_layers + 1, n_layers   # norm1 per layer + final_norm
    return {
        "norm1": (batch * prompt, d_model, bf16, bf16, norms),
        "gated": (batch * prompt, d_inner, f32, bf16, gated),
        "norm1_decode": (batch, d_model, bf16, bf16, norms * gen),
        "gated_decode": (batch, d_inner, f32, bf16, gated * gen),
    }


def _sets(rows: int, d: int, x_dtype, w_dtype, n: int, seed: int,
          device) -> tuple[torch.Tensor, torch.Tensor]:
    g = torch.Generator(device).manual_seed(seed)
    xs = torch.randn((n, rows, d), generator=g, device=device).to(x_dtype)
    ws = torch.randn((n, d), generator=g, device=device).to(w_dtype)
    return xs, ws


def warm_ms(fn, x: torch.Tensor, w: torch.Tensor,
            reps: int = WARM_REPS) -> float:
    return timing.timed_ms(lambda: fn(x, w), reps, warmup=3)


def cold_ms(fn, xs: torch.Tensor, ws: torch.Tensor, l2_bytes: int) -> float:
    n = xs.shape[0]
    sets = [(xs[i], ws[i]) for i in range(n)]
    ring = [None] * n               # each output lives until its set recurs

    def call(i):
        def run():
            ring[i % n] = fn(*sets[i % n])
        return run

    flush = torch.zeros(2 * l2_bytes // 4, device=xs.device)

    def evict():
        flush.sum()                 # x's sets leave the L2

    fn(*sets[0])
    calls = [call(i) for i in range(n * math.ceil(COLD_CALLS / n))]
    return timing.queued_ms(calls, evict)


def cold_sets(rows: int, d: int, x_dtype, l2_bytes: int) -> int:
    """Sets whose x together exceed twice the L2, one more for margin, at
    most MAX_SETS."""
    x_bytes = rows * d * torch.empty((), dtype=x_dtype).element_size()
    return min(MAX_SETS, math.ceil(2 * l2_bytes / x_bytes) + 1)


def library(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One PyTorch call for the same function (w in x's dtype)."""
    return torch.nn.functional.rms_norm(x, (x.shape[1],), w.to(x.dtype),
                                        eps=EPS)


def time_shapes(fns: dict, shapes: dict, rounds: int = 2,
                seed: int = 0) -> dict:
    """Time each of ``fns`` (name -> fn(x, w)) at each shape, cold and
    warm, in turns (the order reversed every other round).  Returns, per
    shape, the cold-set count, the least time of the work (x and w read,
    out written; ms) and what bounds it, and per fn the mean cold and warm
    ms and each round's readings."""
    dev = torch.device("cuda")
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    res = {}
    for si, (name, (rows, d, xdt, wdt, _)) in enumerate(shapes.items()):
        n = cold_sets(rows, d, xdt, l2)
        xs, ws = _sets(rows, d, xdt, wdt, n, seed + si, dev)
        lib_ws = ws.to(xdt)         # the library's w, made outside the timing
        args = {f: (ws if f != "library" else lib_ws) for f in fns}
        reads = {f: {"cold": [], "warm": []} for f in fns}
        order = list(fns)
        for r in range(rounds):
            for f in (order if r % 2 == 0 else order[::-1]):
                fn = fns[f]
                reads[f]["warm"].append(warm_ms(fn, xs[0], args[f][0]))
                reads[f]["cold"].append(cold_ms(fn, xs, args[f], l2))
        x0, w0 = xs[0], ws[0]
        b_ms, b_by = timing.bound([x0, w0, x0], rows * d, FLOPS_PER_ELEMENT)
        res[name] = {
            "sets": n, "bound_ms": b_ms, "bound_by": b_by,
            **{f: {m: sum(v) / len(v) for m, v in rd.items()}
               | {"reads": rd} for f, rd in reads.items()}}
        del xs, ws, lib_ws
    return res


def check_shapes(fns: dict, shapes: dict, seed: int = 0) -> dict:
    """Each fn against ``rmsnorm_ref`` at each shape, at the JAX sweep's
    tolerances; returns per shape max|err| of each fn."""
    dev = torch.device("cuda")
    errs = {}
    for si, (name, (rows, d, xdt, wdt, _)) in enumerate(shapes.items()):
        xs, ws = _sets(rows, d, xdt, wdt, 1, seed + si, dev)
        want = rmsnorm_ref(xs[0], ws[0], EPS).float()
        errs[name] = {}
        for f, fn in fns.items():
            got = fn(xs[0], ws[0]).float()
            torch.testing.assert_close(got, want, rtol=TOL[xdt],
                                       atol=TOL[xdt])
            errs[name][f] = float((got - want).abs().max())
    return errs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device is available")
    fns = {"kernel": lambda x, w: K.rmsnorm(x, w, EPS), "library": library}
    copy = {"copy": lambda x, w: x.clone()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"kernel {K.__file__}")
    shapes = path_shapes(1024, 2048, 48, 4, 2048, 64)   # mamba2-370m serve
    errs = check_shapes(fns, shapes)
    res = time_shapes(fns | copy, shapes)
    for name, r in res.items():
        rows, d, xdt, wdt, launches = shapes[name]
        b_us = r["bound_ms"] * 1e3
        print(f"{name} ({rows}, {d}) x {str(xdt)[6:]}, w {str(wdt)[6:]}: "
              f"{r['sets']} cold sets, bound {b_us:.3f} us "
              f"({r['bound_by']}), {launches} launches per serve run")
        for f in fns | copy:
            c, w = r[f]["cold"] * 1e3, r[f]["warm"] * 1e3
            reads = ", ".join(f"{m} " + "/".join(f"{v * 1e3:.2f}" for v in
                                                 r[f]["reads"][m])
                              for m in ("cold", "warm"))
            err = f"; max|err| {errs[name][f]:.3e}" if f in fns else ""
            print(f"    {f:12s} cold {c:8.2f} us ({100 * b_us / c:5.1f}% of "
                  f"bound), warm {w:8.2f} us; reads {reads}{err}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
