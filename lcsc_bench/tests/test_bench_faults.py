"""A run with the timed path broken underneath comes out not correct:
for each fault the cells can have.  (One card and one source or system
a call: no batch to halve, no exchange between cards to drop.)"""
from types import SimpleNamespace

import pytest

from lcsc_bench.lib import spec

LQCD = ["lqcd-thermal-solve", "lqcd-cold-solve"]


def lqcd_fault(kind):
    base = spec.cell(LQCD[0], False).driver.Driver

    class Faulty(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            solve = self.solve

            def broken(U, b, kappa, solver):
                res = solve(U, b, kappa, solver)
                x = res.x.clone()
                if kind == "unchanged":
                    x.zero_()                 # the solver's starting state
                else:
                    x.view(-1)[5] += 1e-3     # one answer altered
                return SimpleNamespace(x=x, iters=res.iters,
                                       outer_iters=res.outer_iters,
                                       converged=res.converged)
            self.solve = broken
    return Faulty


def hpl_fault(kind):
    base = spec.cell("hpl-n65536-run", False).driver.Driver

    class Faulty(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            factor, solve = self.factor, self.solve

            def no_factor(a, nb, lookahead):
                res = factor(a, nb, lookahead=lookahead)
                return res._replace(lu=a.clone())   # the input, unchanged

            def altered(res, b, nb):
                x = solve(res, b, nb)
                x[3] += 1.0
                return x
            if kind == "unchanged":
                self.factor = no_factor
            else:
                self.solve = altered
    return Faulty


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
@pytest.mark.parametrize("name", LQCD)
def test_lqcd_fault_is_caught(tiny_run, name, kind):
    out = tiny_run(name, lqcd_fault(kind))
    assert not out["correct"]


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_hpl_fault_is_caught(tiny_run, kind):
    out = tiny_run("hpl-n65536-run", hpl_fault(kind))
    assert not out["correct"]
