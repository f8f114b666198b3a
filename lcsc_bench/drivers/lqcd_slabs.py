"""Driver of the LQCD cells whose lattice is T-sharded over the cell's
cards: one gauge field per run, held as T-slabs (one a card) from the
moment it is drawn, and one call of
``repro_torch.lqcd.solve_dirac(U_slabs, b_slabs, kappa, solver, mesh=)``
per source, each source drawn as slabs too (``lib/slabs.py``: every
T-row from (seed, row) on its slab's card, so the field does not depend
on the number of cards).

An item is one solve, timed by the host clock from the call to its
return, which comes after the program has read its true residual back
to the host, so its ``x`` is finished on the cards.  Outside the timed
call the answer's slabs are gathered into one tensor on the first card,
for the harness's answer slots.  The answers are judged by the plain
reference in slabs (``reference/wilson_slabs.py``, complex128), each slab
on its card: the true relative residual ‖b − M x‖ / ‖b‖ of every kept
solve, against the configuration's tolerance.  The work count is the
count of normal operators the configuration states
(``check.work_normal_ops``, the same reference's CGNE's; its ``assumed``
says where it was counted): at this lattice the reference's CGNE
outlasts a run.  Set-up first gives the power sampler's pipe room for a
run's samples of four boards (``lib/sampler_pipe.py``).
"""
from __future__ import annotations

import functools
import time
from types import SimpleNamespace

import torch

from lcsc_bench.lib import counts, sampler_pipe, slabs
from lcsc_bench.lib.peaks import least_s
from lcsc_bench.lib.seeds import mix
from lcsc_bench.reference import wilson_slabs

GAUGE, SOURCE = 0, 1
T_AX = 3                  # the T axis of a spinor


class SlabControl:
    """``solve_dirac``'s place in the control: the slab reference's
    even-odd CGNE with every field rounded through bfloat16 (the
    configuration states float32), given the normal operators the
    configuration allows the program (``max_iters``)."""

    def __init__(self):
        self.op = self.U = None

    def __call__(self, U, b, kappa, solver):
        if self.U is not U:
            self.op = wilson_slabs.SlabWilson(U, kappa, dtype=torch.complex64,
                                              low=torch.bfloat16)
            self.U = U
        x, n = wilson_slabs.solve(self.op, b, solver.tol, solver.max_iters)
        return SimpleNamespace(x=[v.to(torch.complex64) for v in x], iters=n,
                               outer_iters=0, converged=True)


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, devices):
        from repro_torch.config import SolverConfig
        from repro_torch.distributed import LatticeMesh
        from repro_torch.lqcd import solve_dirac
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.devices = [torch.device(d) for d in devices]
        shards = int(cfg["mesh"]["shards"])
        if len(self.devices) != shards:
            raise ValueError(f"{shards} T-shards need as many cards, got "
                             f"{len(self.devices)}")
        self.mesh = LatticeMesh(tuple(self.devices))
        self.solve = functools.partial(solve_dirac, mesh=self.mesh)
        self.lattice = tuple(cfg["lattice"])
        self.t_slab = self.lattice[3] // shards
        self.kappa = float(cfg["kappa"])
        self.solver = SolverConfig(**cfg["solver"])
        self.volume = 1
        for s in self.lattice:
            self.volume *= s

    def use_control(self) -> None:
        """Put the cell's control (``SlabControl``) in the timed path."""
        self.solve = SlabControl()

    def source(self, i: int) -> list:
        return slabs.spinor(mix(self.seed, SOURCE, i), self.lattice,
                            self.devices)

    def whole(self, x) -> torch.Tensor:
        """The answer's slabs as one tensor on the first card."""
        return torch.cat([v.to(self.devices[0]) for v in x], T_AX)

    def slabs_of(self, x: torch.Tensor) -> list:
        """A whole answer cut back into slabs, each on its card."""
        ts = self.t_slab
        return [x.narrow(T_AX, j * ts, ts).to(d)
                for j, d in enumerate(self.devices)]

    def setup(self) -> None:
        # four boards' samples outgrow the sampler's pipe before the window
        self.smi_pipe = sampler_pipe.widen()
        self.U = slabs.su3_field(mix(self.seed, GAUGE), self.lattice,
                                 self.devices)
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
                 "failed": not res.converged}, self.whole(res.x))

    def check(self, kept: dict) -> dict:
        """The largest true residual of the kept solves, beside the
        configuration's limit."""
        self.op = wilson_slabs.SlabWilson(self.U, self.kappa)
        residuals = [wilson_slabs.true_residual(
            self.op, self.slabs_of(kept[i]), self.source(i))
            for i in sorted(kept)]
        return {"residual_max": (max(residuals, default=float("inf")),
                                 float(self.cfg["check"]["residual_max"]))}

    def work(self, kept: dict) -> dict:
        """The reference's normal operators a solve (the stated count), and
        the flops and least seconds of a solve that needs them, at the HBM
        rate and f32 peak of all the cell's cards."""
        sol = self.cfg["solver"]
        ref_ops = float(self.cfg["check"]["work_normal_ops"])
        flops = counts.solve_flops(self.volume, ref_ops)
        nbytes = counts.solve_bytes(self.volume, ref_ops, sol["inner_dtype"],
                                    self.cfg["dtype"])
        cards = len(self.devices)
        return {"ref_normal_ops": ref_ops, "item_flops": flops,
                "item_least_s": least_s(flops / cards, nbytes / cards)}

    def notes(self, rec: dict) -> str:
        walls = [c["wall_s"] for c in rec["counters"]]
        ops = sorted({(c["inner"], c["outer"]) for c in rec["counters"]})
        return (f"{rec['items']} solves over {len(self.devices)} T-slabs of "
                f"{self.t_slab} in {rec['window_s']:.3f} s (first "
                f"{walls[0] * 1e3:.2f} ms, min {min(walls) * 1e3:.2f}, max "
                f"{max(walls) * 1e3:.2f}); (inner, outer) normal ops seen "
                f"{ops}; the reference's normal ops {rec['ref_normal_ops']}; "
                f"nvidia-smi's pipe widened to {self.smi_pipe} B; "
                f"{rec['power_samples']} power samples, mean "
                f"{rec['watts']:.2f} W over the boards, SM clock "
                f"{rec['sm_clock_mhz']:.0f} MHz")
