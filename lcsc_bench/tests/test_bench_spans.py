"""The rollup by the program's spans (``lib/spans.py``) on event lists
made by hand, and on the CPU profile of tiny cells (``span_rollup.py``)."""
import pytest

from lcsc_bench.lib import spans, trace
from lcsc_bench.tests.conftest import tiny_cell
from lcsc_bench.tests.events import CPU, CUDA, Ev, launch, span

# a solve [0, 1000) of two iterations, the first with a normal op and a
# host sync; a launch under each of normal_op, cg.iter, host_sync and
# the solve, the last running past the solve's end
EVENTS = [span("lqcd.solve", 0, 1000), span("lqcd.cg.iter", 100, 300),
          span("lqcd.normal_op", 150, 100), span("lqcd.host_sync", 350, 50),
          span("lqcd.cg.iter", 500, 300),
          Ev("aten::mul", CPU, 160, 30, corr=2),   # the op's own id space
          *launch("k1", 120, 80, 1, 160), *launch("k2", 260, 80, 2, 255),
          *launch("copy", 380, 10, 3, 355), *launch("k4", 1000, 50, 4, 990)]


def test_busy_idle_and_launches():
    r = spans.rollup(EVENTS, -100, 1100)
    assert r["window_s"] == pytest.approx(1200e-9)
    assert r["busy_s"] == pytest.approx(220e-9)
    s = r["spans"]
    assert {n: v["count"] for n, v in s.items()} == {
        "lqcd.solve": 1, "lqcd.cg.iter": 2, "lqcd.normal_op": 1,
        "lqcd.host_sync": 1}
    assert {n: v["launches"] for n, v in s.items()} == {
        "lqcd.solve": 1, "lqcd.cg.iter": 1, "lqcd.normal_op": 1,
        "lqcd.host_sync": 1}
    assert s["lqcd.cg.iter"]["launches_total"] == 3
    assert s["lqcd.solve"]["launches_total"] == 4
    assert r["outside"]["launches"] == 0 and r["unmatched"] == 0
    # gaps by midpoint: [-100, 120) at 10 in the solve; [200, 260) at 230
    # in normal_op; [340, 380) at 360 in host_sync; [390, 1000) at 695 in
    # the second iteration; [1050, 1100) at 1075 under no span
    assert s["lqcd.solve"]["idle_s"] == pytest.approx(220e-9)
    assert s["lqcd.normal_op"]["idle_s"] == pytest.approx(60e-9)
    assert s["lqcd.host_sync"]["idle_s"] == pytest.approx(40e-9)
    assert s["lqcd.cg.iter"]["idle_s"] == pytest.approx(610e-9)
    assert r["outside"]["idle_s"] == pytest.approx(50e-9)
    assert s["lqcd.cg.iter"]["idle_total_s"] == pytest.approx(710e-9)
    assert s["lqcd.solve"]["idle_total_s"] == pytest.approx(930e-9)


def test_idle_under_spans_and_outside_is_the_stretch_s():
    r = spans.rollup(EVENTS, -100, 1100)
    under = sum(v["idle_s"] for v in r["spans"].values())
    assert under + r["outside"]["idle_s"] == pytest.approx(r["idle_s"])
    assert r["idle_s"] == pytest.approx(r["window_s"] - r["busy_s"])
    # the busy time is summarize's, which reads the same device events
    assert r["busy_s"] == pytest.approx(
        trace.summarize(EVENTS, -100, 1100)["busy_s"])


def test_self_time_is_the_span_less_its_children():
    s = spans.rollup(EVENTS, 0, 1000)["spans"]
    assert s["lqcd.solve"]["self_s"] == pytest.approx(400e-9)
    assert s["lqcd.cg.iter"]["self_s"] == pytest.approx(450e-9)
    assert s["lqcd.cg.iter"]["total_s"] == pytest.approx(600e-9)
    assert s["lqcd.normal_op"]["self_s"] == pytest.approx(100e-9)


def test_a_device_user_annotation_is_not_device_activity():
    annotated = EVENTS + [Ev("lqcd.solve", CUDA, 0, 1000, corr=9,
                             annotation=True)]
    assert spans.rollup(annotated, 0, 1000) == spans.rollup(EVENTS, 0, 1000)


def test_a_launch_without_its_runtime_call_is_counted_unmatched():
    r = spans.rollup(EVENTS + [Ev("k3", CUDA, 900, 10, corr=7)], 0, 1000)
    assert r["unmatched"] == 1
    assert r["spans"]["lqcd.solve"]["launches_total"] == 4


def test_the_program_s_names_are_read():
    from repro_torch import spans as program
    assert all(n.startswith(spans.PREFIXES) for n in program.NAMES)


@pytest.mark.parametrize("name", ["lqcd-thermal-solve", "hpl-n65536-run"])
def test_a_tiny_cell_s_profile(name):
    from lcsc_bench.span_rollup import profile_cell
    from repro_torch import spans as program
    cell = tiny_cell(name, True)
    r = profile_cell(cell, 2 ** 33 + 17, 2, devices=["cpu"])
    assert set(r["spans"]) <= set(program.NAMES)
    got = {n: v["count"] for n, v in r["spans"].items()}
    c = r["counters"]
    if name.startswith("lqcd"):
        inner = sum(x["inner"] for x in c)
        outer = sum(x["outer"] for x in c)
        assert got[program.LQCD_SOLVE] == 2
        assert got[program.LQCD_CG_ITER] == inner
        assert got[program.LQCD_HOST_SYNC] == inner + 3 * outer + 6
    else:
        assert got[program.HPL_PANEL] == 2 * 8
        assert got[program.HPL_SOLVE_PERM] == 2
    # no device on the CPU: the stretch is idle, every gap under a span
    assert r["busy_s"] == r["summarize"]["busy_s"] == 0
    under = sum(v["idle_s"] for v in r["spans"].values())
    assert under + r["outside"]["idle_s"] == pytest.approx(r["idle_s"])
