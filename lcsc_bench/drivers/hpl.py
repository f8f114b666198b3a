"""Driver of the HPL cell: per item a fresh A and b from (seed, index),
``repro_torch.hpl.blocked_lu(a, nb, lookahead=...)`` and
``lu_solve(res, b, nb)``, ended by a synchronisation of the device.

Every answer of the window is judged by the plain reference
(``reference/hpl.py``): HPL's scaled residual of x, in float64, with A
and b made again from their seed.  The work count is HPL's own,
2/3 n³ + 3/2 n² an item.
"""
from __future__ import annotations

import time

import torch

from lcsc_bench.lib import counts, inputs
from lcsc_bench.lib.seeds import mix
from lcsc_bench.reference import hpl as reference

SYSTEM = 2


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, devices):
        from repro_torch.hpl import blocked_lu, lu_solve
        self.factor, self.solve = blocked_lu, lu_solve   # the timed path
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        (self.device,) = map(torch.device, devices)     # one card
        self.n, self.nb = int(cfg["n"]), int(cfg["nb"])
        self.lookahead = int(cfg["lookahead"])
        if cfg["dtype"] != "float32":
            raise ValueError("the program runs HPL in float32 only")

    def use_control(self) -> None:
        """Put the cell's control in the timed path: the reference's
        blocked LU with the trailing updates' operands rounded to TF32
        (the configuration states IEEE float32, TF32 off)."""
        self.factor = lambda a, nb, lookahead: a
        self.solve = lambda a, b, nb: reference.lu_solve(a, b, nb, tf32=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def system(self, i: int, n: int | None = None):
        return inputs.hpl_system(mix(self.seed, SYSTEM, i), n or self.n,
                                 self.device)

    def setup(self) -> None:
        """Load the kernels and the libraries the path calls at the
        traffic's warm-up size, then make one system at the cell's size,
        so that the window's first item finds its memory cached."""
        n = min(self.n, int(self.traffic["warmup_n"]))
        a, b = self.system(-1, n)
        self.solve(self.factor(a, self.nb, lookahead=self.lookahead), b,
                   self.nb)
        del a, b
        a, b = self.system(-2)
        lu = torch.empty_like(a)
        self.answer_like = torch.empty_like(b)
        del a, b, lu
        self.sync()

    def item(self, i: int):
        a, b = self.system(i)
        t0 = time.perf_counter()
        res = self.factor(a, self.nb, lookahead=self.lookahead)
        x = self.solve(res, b, self.nb)
        self.sync()
        wall = time.perf_counter() - t0
        return {"wall_s": wall, "failed": False}, x

    def check(self, kept: dict) -> dict:
        """The largest scaled residual of the judged runs beside the
        configuration's limit."""
        self.residuals = []
        for i in sorted(kept):
            a, b = self.system(i)
            self.residuals.append(reference.scaled_residual(a, kept[i], b))
            del a, b
        return {"scaled_residual_max": (
            max(self.residuals, default=float("inf")),
            float(self.cfg["check"]["scaled_residual_max"]))}

    def work(self, kept: dict) -> dict:
        """HPL's flops of an item."""
        return {"item_flops": counts.hpl_flops(self.n)}

    def notes(self, rec: dict) -> str:
        walls = ", ".join(f"{c['wall_s']:.4f}" for c in rec["counters"])
        return (f"{rec['items']} runs in {rec['window_s']:.3f} s, walls "
                f"[{walls}] s; scaled residuals {self.residuals}; "
                f"{rec['power_samples']} power samples, mean "
                f"{rec['watts']:.2f} W, SM clock {rec['sm_clock_mhz']:.0f} MHz")
