"""The metric readers and the trace reader on records made by hand."""
import pytest
from torch.autograd import DeviceType

from lcsc_bench.lib import counts, spec, trace
from lcsc_bench.lib.peaks import HBM_BW, PEAK_F32_FLOPS
from lcsc_bench.tests.events import Ev

READERS = {m["name"]: spec.load_module(
    spec.BENCH_DIR / "metrics" / f"{m['name']}.py", "t_")
    for part in ("end_to_end", "per_layer") for m in spec.benchmark()[part]}


def test_trace_busy_ops_and_gaps():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [Ev("k1", cuda, 100, 100), Ev("k1", cuda, 150, 100),
              Ev("k2", cuda, 600, 200),
              Ev("aten::outer", cpu, 0, 1000), Ev("aten::item", cpu, 300, 200)]
    s = trace.summarize(events, 0, 1000)
    assert s["window_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx(350e-9)       # [100, 250) + [600, 800)
    assert s["ops"] == {"k1": [pytest.approx(200e-9), 2],
                        "k2": [pytest.approx(200e-9), 1]}
    # gaps [0,100) and [800,1000) under the outer op, [250,600) mid 425 in item
    assert s["gaps"] == {"aten::outer": pytest.approx(300e-9),
                         "aten::item": pytest.approx(350e-9)}
    b = trace.breakdown(s)
    assert b["idle_gaps"][0][0] == "aten::item"
    assert len(b["device_ops"]) == 2


def test_gap_outside_any_host_op():
    s = trace.summarize([Ev("k", DeviceType.CUDA, 10, 10)], 0, 40)
    assert s["gaps"] == {trace.HOST_BETWEEN_OPS: pytest.approx(30e-9)}


WINDOW_READERS = ("solve_ms", "solve_ms_p95", "gflops_per_w", "solve.mfu",
               "board_w", "solve.normal_ops")


def test_window_metrics():
    rec = {"setup_s": 7.5, "window_s": 2.0, "items": 4, "item_flops": 1e12,
           "joules": 400.0, "watts": 200.0, "item_least_s": 0.05,
           "counters": [{"wall_s": w, "normal_ops": 22, "inner": 19,
                         "outer": 3} for w in (0.4, 0.5, 0.5, 0.6)]}
    assert READERS["setup_s"].read(rec) == 7.5
    assert READERS["solve_ms"].read(rec) == pytest.approx(500.0)
    assert READERS["solve_ms_p95"].read(rec) == pytest.approx(585.0)
    assert READERS["hpl_gflops"].read(rec) == pytest.approx(2000.0)
    assert READERS["gflops_per_w"].read(rec) == pytest.approx(10.0)
    assert READERS["solve.mfu"].read(rec) == pytest.approx(10.0)
    assert READERS["hpl.mfu"].read(rec) == pytest.approx(
        100 * 2e12 / PEAK_F32_FLOPS)
    assert READERS["board_w"].read(rec) == 200.0
    assert READERS["solve.normal_ops"].read(rec) == 22
    # the cold cell's metrics are the same quantities under bounds of
    # their own
    for name, r in READERS.items():
        if name.endswith(".cold") and name[:-5] in WINDOW_READERS:
            assert r.read(rec) == READERS[name[:-5]].read(rec)


def test_dslash_roofline_counts_each_hop_at_its_precision():
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "lqcd-thermal-32c8.json")
    V = 32 ** 3 * 8
    tr = {"counters": [{"inner": 19, "outer": 3}] * 2,
          "ops": {"dslash_eo_kernel(float2 const*)": [0.01, 180]},
          "busy_s": 0.02, "window_s": 0.05}
    nbytes = 2 * (76 * counts.hop_bytes(V, "bfloat16")
                  + 14 * counts.hop_bytes(V, "float32"))
    rec = {"trace": tr, "config": cfg}
    assert READERS["dslash_eo_roofline"].read(rec) == pytest.approx(
        100 * nbytes / HBM_BW / 0.01)
    assert READERS["device_idle.solve"].read(rec) == pytest.approx(60.0)
    for name in ("dslash_eo_roofline", "device_idle.solve"):
        assert READERS[name + ".cold"].read(rec) == READERS[name].read(rec)
    tr["ops"] = {"dslash_eo_kernel": [0.01, 179]}      # a hop unaccounted
    assert READERS["dslash_eo_roofline"].read(rec) is None
    assert READERS["dslash_eo_roofline"].read({"trace": None,
                                               "config": cfg}) is None


def test_dgemm_roofline():
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "hpl-n65536.json")
    tr = {"counters": [{}], "ops": {"gemm_kernel<128>": [4.0, 509]}}
    got = READERS["dgemm_roofline"].read({"trace": tr, "config": cfg})
    # the updates are compute-bound: ~2/3 n^3 flops at the f32 peak
    assert 60 < got < 75
    tr["ops"] = {"gemm_kernel<128>": [4.0, 508]}
    assert READERS["dgemm_roofline"].read({"trace": tr, "config": cfg}) is None


@pytest.mark.parametrize("items", [3, 10])
def test_kept_answers_are_copies_of_the_window_s(items):
    """Every answer while the slots hold them, a sample of as many as
    they hold after that, each slot holding its own item's answer."""
    import torch

    from lcsc_bench.run import Kept
    kept = Kept(4, 2 ** 40 + 3, torch.empty(5))
    for i in range(items):
        kept.offer(i, torch.full((5,), float(i)))
    got = kept.answers()
    assert len(got) == min(items, 4)
    assert len(set(got)) == len(got) and set(got) <= set(range(items))
    for i, x in got.items():
        assert torch.equal(x, torch.full((5,), float(i)))


def test_busy_seconds_per_card():
    """Two cards: each card's union of its own activities, and the union
    over both as ``busy_s``; a device user annotation counts on none."""
    from lcsc_bench.run import busy_per_card
    from lcsc_bench.tests.events import CUDA
    events = [Ev("k", CUDA, 100, 100, index=0), Ev("k", CUDA, 150, 100,
                                                    index=0),
              Ev("k", CUDA, 200, 300, index=1), Ev("k", CUDA, 900, 50,
                                                    index=1),
              Ev("lqcd.solve", CUDA, 0, 1000, index=1, annotation=True)]
    s = trace.summarize(events, 0, 1000)
    assert s["busy_s_by_card"] == {0: pytest.approx(150e-9),
                                   1: pytest.approx(350e-9)}
    assert s["busy_s"] == pytest.approx(450e-9)       # [100, 500) + [900, 950)
    assert busy_per_card(s, 4) == [pytest.approx(150e-9),
                                   pytest.approx(350e-9), 0.0, 0.0]
    one = trace.summarize(events[:2], 0, 1000)
    assert busy_per_card(one, 1) == [one["busy_s"]]


def test_the_fullest_card_s_peak():
    from lcsc_bench.run import memory_peaks
    got = memory_peaks(["cuda:0", "cuda:1", "cuda:2", "cuda:3"],
                       {"cuda:0": 5, "cuda:1": 9, "cuda:2": 7,
                        "cuda:3": 1}.get)
    assert got == {"memory_peak_bytes": 9,
                   "memory_peak_bytes_per_card": [5, 9, 7, 1]}
    assert memory_peaks(["cuda:0"], lambda d: 17) == {
        "memory_peak_bytes": 17, "memory_peak_bytes_per_card": [17]}


def test_summarize_keeps_the_rollup_of_the_same_events():
    from lcsc_bench.lib import spans
    from lcsc_bench.tests.test_bench_spans import EVENTS
    assert trace.summarize(EVENTS, -100, 1100)["spans"] == \
        spans.rollup(EVENTS, -100, 1100)


def test_the_span_metrics():
    """The seven readers of the program's spans on a rollup made by hand:
    two solves, 800 CG iterations; one HPL run of 256 panels."""
    def rolled(names=None):
        return {"trace": {"window_s": 2.0, "spans": {"spans": names or {}}}}
    lq = rolled({"lqcd.solve": {"count": 2},
                 "lqcd.host_sync": {"count": 818},
                 "lqcd.cg.iter": {"count": 800, "launches_total": 27200,
                                  "idle_total_s": 1.2},
                 "lqcd.normal_op": {"count": 800, "idle_total_s": 0.8}})
    assert READERS["solve.host_syncs"].read(lq) == 409.0
    assert READERS["solve.launches_per_iter"].read(lq) == 34.0
    assert READERS["device_idle.solve.normal_op"].read(lq) == \
        pytest.approx(40.0)
    assert READERS["device_idle.solve.cg_update"].read(lq) == \
        pytest.approx(20.0)
    hpl = rolled({"hpl.panel": {"count": 256, "launches_total": 768,
                                "idle_total_s": 0.0005},
                  "hpl.solve": {"count": 1, "idle_total_s": 0.025}})
    assert READERS["hpl.panel_launches"].read(hpl) == 3.0
    assert READERS["device_idle.hpl.panel"].read(hpl) == pytest.approx(0.025)
    assert READERS["device_idle.hpl.solve"].read(hpl) == pytest.approx(1.25)
    # nothing to read: not traced, or no such span in the stretch
    for name in ("solve.host_syncs", "solve.launches_per_iter",
                 "device_idle.solve.normal_op", "device_idle.solve.cg_update",
                 "hpl.panel_launches", "device_idle.hpl.panel",
                 "device_idle.hpl.solve"):
        assert READERS[name].read({"trace": None}) is None
        assert READERS[name].read(rolled()) is None
