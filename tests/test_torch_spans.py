"""The port's program spans (``repro_torch.spans``) on the CPU: they cost
no record when no profiler records, change no value, and mark the LQCD
solve and HPL's factorization and solve with the counts and nesting the
code has."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs.lcsc_lqcd import EO_MIXED_SOLVER
from repro_torch.hpl import blocked_lu, lu_solve
from repro_torch.lqcd import solve_dirac
from repro_torch.lqcd.su3 import random_field_and_source

LATTICE = (4, 4, 4, 4)
KAPPA = 0.137


def _solve():
    U, b = random_field_and_source(LATTICE, 11, "cpu")
    return solve_dirac(U, b, KAPPA, EO_MIXED_SOLVER)


def _hpl(n=256, nb=32, lookahead=1):
    gen = torch.Generator().manual_seed(5)
    a = torch.randn((n, n), generator=gen)
    b = torch.randn((n,), generator=gen)
    res = blocked_lu(a, nb, lookahead=lookahead)
    return res, lu_solve(res, b, nb)


def _profiled(fn):
    """``fn()`` under a CPU profiler: its result and the program's spans
    as (start_ns, end_ns, name), sorted by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    found = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name() in spans.NAMES)
    return out, found


def _count(found, name):
    return sum(1 for *_, n in found if n == name)


def _inside(found, inner, outer):
    """Every ``inner`` span lies inside some ``outer`` span."""
    outs = [(s, e) for s, e, n in found if n == outer]
    return all(any(s0 <= s and e <= e0 for s0, e0 in outs)
               for s, e, n in found if n == inner)


def test_no_record_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a record for {name} with no profiler on")

    monkeypatch.setattr(spans, "_record", refuse)
    assert spans.span(spans.LQCD_SOLVE) is spans._OFF
    res = _solve()
    assert res.converged
    _hpl()


def test_values_equal_with_and_without_a_profiler():
    off = _solve()
    on, found = _profiled(_solve)
    assert found, "the profiler saw no span"
    assert torch.equal(off.x, on.x)
    assert (off.iters, off.outer_iters, off.rel_residual) == \
        (on.iters, on.outer_iters, on.rel_residual)
    (res0, x0), ((res1, x1), _) = _hpl(), _profiled(_hpl)
    assert torch.equal(res0.lu, res1.lu) and torch.equal(res0.piv, res1.piv)
    assert torch.equal(x0, x1)


def test_eo_solve_spans_count_and_nest():
    res, found = _profiled(_solve)
    assert res.converged and res.outer_iters >= 2
    inner, outer = res.iters, res.outer_iters
    assert _count(found, spans.LQCD_SOLVE) == 1
    assert _count(found, spans.LQCD_EO_PREPARE) == 1
    assert _count(found, spans.LQCD_EO_FINISH) == 1
    assert _count(found, spans.LQCD_EO_OUTER) == outer
    assert _count(found, spans.LQCD_CG_ITER) == inner
    assert _count(found, spans.LQCD_NORMAL_OP) == inner
    # per round the outer test, the inner CG's inner + 1 stopping tests
    # and its residual; then the last outer test, |b| and the true residual
    assert _count(found, spans.LQCD_HOST_SYNC) == inner + 3 * outer + 3
    assert _inside(found, spans.LQCD_NORMAL_OP, spans.LQCD_CG_ITER)
    assert _inside(found, spans.LQCD_CG_ITER, spans.LQCD_EO_OUTER)
    for name in (spans.LQCD_EO_OUTER, spans.LQCD_EO_PREPARE,
                 spans.LQCD_EO_FINISH, spans.LQCD_HOST_SYNC):
        assert _inside(found, name, spans.LQCD_SOLVE)
    assert not _inside(found, spans.LQCD_CG_ITER, spans.LQCD_NORMAL_OP)


@pytest.mark.parametrize("lookahead, updates", [
    (1, {spans.HPL_UPDATE_NEXT: 7, spans.HPL_UPDATE_REST: 6,
         spans.HPL_UPDATE: 0}),
    (0, {spans.HPL_UPDATE_NEXT: 0, spans.HPL_UPDATE_REST: 0,
         spans.HPL_UPDATE: 7})])
def test_hpl_spans_count_and_nest(lookahead, updates):
    _, found = _profiled(lambda: _hpl(256, 32, lookahead))
    want = {spans.HPL_LU: 1, spans.HPL_PANEL: 8, spans.HPL_TRSM: 7,
            spans.HPL_SOLVE: 1, spans.HPL_SOLVE_PERM: 1,
            spans.HPL_SOLVE_TRSV: 1, spans.HPL_HOST_SYNC: 1, **updates}
    assert {n: _count(found, n) for n in want} == want
    for name in (spans.HPL_PANEL, spans.HPL_TRSM, spans.HPL_UPDATE_NEXT,
                 spans.HPL_UPDATE_REST, spans.HPL_UPDATE):
        assert _inside(found, name, spans.HPL_LU)
    assert _inside(found, spans.HPL_HOST_SYNC, spans.HPL_SOLVE_PERM)
    for name in (spans.HPL_SOLVE_PERM, spans.HPL_SOLVE_TRSV):
        assert _inside(found, name, spans.HPL_SOLVE)


def test_names():
    assert len(set(spans.NAMES)) == len(spans.NAMES)
    assert all(n.startswith(("lqcd.", "hpl.")) for n in spans.NAMES)
    syncs = [n for n in spans.NAMES if n.endswith(".host_sync")]
    assert syncs == [spans.LQCD_HOST_SYNC, spans.HPL_HOST_SYNC]


def test_host_sync_reads_as_float_and_bool_do():
    t = torch.tensor(0.1, dtype=torch.float32)
    got = spans.host_sync(t, spans.LQCD_HOST_SYNC)
    assert type(got) is float and got == float(t)
    assert spans.host_sync(t > 0, spans.LQCD_HOST_SYNC) is True
    # the same operations as float(t): no copy to a host tensor first
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        float(t)
        spans.host_sync(t, spans.LQCD_HOST_SYNC)
    ops = [e.name() for e in prof.profiler.kineto_results.events()
           if e.name() != spans.LQCD_HOST_SYNC]
    half = len(ops) // 2
    assert ops[:half] == ops[half:] and "aten::item" in ops
