"""Driver of the LQCD cells: one gauge field per run, and one call of
``repro_torch.lqcd.solve_dirac(U, b, kappa, solver)`` per source, each
source fresh from (seed, index).

An item is one solve, timed by the host clock from the call to its
return, which comes after the program has read its true residual back
to the host, so its ``x`` is finished on the device.  The answers are
judged by the plain reference (``reference/wilson.py``, complex128): the
true relative residual ‖b − M x‖ / ‖b‖ of every kept solve (all of the
window's, up to the configuration's ``check.answers``), against the
configuration's tolerance.  The same reference solves
``check.work_sources`` of those sources itself, drawn from the seed, and
the normal operators it needs are the work count.
"""
from __future__ import annotations

import random
import time
from types import SimpleNamespace

import torch

from lcsc_bench.lib import counts, inputs
from lcsc_bench.lib.peaks import least_s
from lcsc_bench.lib.seeds import mix
from lcsc_bench.reference import wilson

GAUGE, SOURCE, WORK = 0, 1, 2


class LQCDControl:
    """``solve_dirac``'s place in the control: the reference's even-odd
    CGNE with every field rounded through bfloat16 (the configuration
    states float32), given the normal operators the configuration allows
    the program (``max_iters``)."""

    def __init__(self):
        self.op = self.U = None

    def __call__(self, U, b, kappa, solver):
        if self.U is not U:
            self.op = wilson.WilsonEO(U, kappa, dtype=torch.complex64,
                                      low=torch.bfloat16)
            self.U = U
        x, n = wilson.solve(self.op, b, solver.tol, solver.max_iters)
        return SimpleNamespace(x=x.to(torch.complex64), iters=n,
                               outer_iters=0, converged=True)


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, devices):
        from repro_torch.config import SolverConfig
        from repro_torch.lqcd import solve_dirac
        self.solve = solve_dirac           # the timed path
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        (self.device,) = map(torch.device, devices)     # one card
        self.lattice = tuple(cfg["lattice"])
        self.kappa = float(cfg["kappa"])
        self.solver = SolverConfig(**cfg["solver"])
        self.volume = 1
        for s in self.lattice:
            self.volume *= s

    def use_control(self) -> None:
        """Put the cell's control (``LQCDControl``) in the timed path."""
        self.solve = LQCDControl()

    def source(self, i: int) -> torch.Tensor:
        return inputs.spinor(mix(self.seed, SOURCE, i), self.lattice,
                             self.device)

    def setup(self) -> None:
        self.U = inputs.su3_field(mix(self.seed, GAUGE), self.lattice,
                                  self.device)
        for w in range(int(self.traffic["warmup_items"])):
            _, x = self.item(-1 - w)
        self.answer_like = x

    def item(self, i: int):
        b = self.source(i)
        t0 = time.perf_counter()
        res = self.solve(self.U, b, self.kappa, self.solver)
        wall = time.perf_counter() - t0
        return ({"wall_s": wall, "inner": res.iters,
                 "outer": res.outer_iters,
                 "normal_ops": res.iters + res.outer_iters,
                 "failed": not res.converged}, res.x)

    def check(self, kept: dict) -> dict:
        """The largest true residual of the kept solves, beside the
        configuration's limit."""
        self.op = wilson.WilsonEO(self.U, self.kappa)
        residuals = [wilson.true_residual(self.op, kept[i], self.source(i))
                     for i in sorted(kept)]
        return {"residual_max": (max(residuals, default=float("inf")),
                                 float(self.cfg["check"]["residual_max"]))}

    def work(self, kept: dict) -> dict:
        """The reference's normal operators on ``check.work_sources`` of
        the kept sources, and the flops and least seconds of a solve that
        needs their mean."""
        sol = self.cfg["solver"]
        k = min(int(self.cfg["check"]["work_sources"]), len(kept))
        picked = random.Random(mix(self.seed, WORK)).sample(sorted(kept), k)
        self.ref_ops = [wilson.solve(self.op, self.source(i), sol["tol"],
                                     sol["max_iters"])[1]
                        for i in sorted(picked)]
        ref_ops = (sum(self.ref_ops) / len(self.ref_ops) if self.ref_ops
                   else float("nan"))
        flops = counts.solve_flops(self.volume, ref_ops)
        nbytes = counts.solve_bytes(self.volume, ref_ops, sol["inner_dtype"],
                                    self.cfg["dtype"])
        return {"ref_normal_ops": ref_ops, "item_flops": flops,
                "item_least_s": least_s(flops, nbytes)}

    def notes(self, rec: dict) -> str:
        walls = [c["wall_s"] for c in rec["counters"]]
        ops = sorted({(c["inner"], c["outer"]) for c in rec["counters"]})
        return (f"{rec['items']} solves in {rec['window_s']:.3f} s "
                f"(first {walls[0] * 1e3:.2f} ms, min "
                f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}); "
                f"(inner, outer) normal ops seen {ops}; the reference needed "
                f"{self.ref_ops} on the sampled sources; "
                f"{rec['power_samples']} power samples, mean "
                f"{rec['watts']:.2f} W, SM clock {rec['sm_clock_mhz']:.0f} MHz")
