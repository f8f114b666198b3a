"""The metric readers and the trace reader on records made by hand."""
import pytest
from torch.autograd import DeviceType

from lcsc_bench.lib import counts, spec, trace
from lcsc_bench.lib.peaks import HBM_BW, PEAK_F32_FLOPS

READERS = {m["name"]: spec.load_module(
    spec.BENCH_DIR / "metrics" / f"{m['name']}.py", "t_")
    for part in ("end_to_end", "per_layer") for m in spec.benchmark()[part]}


class Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._u = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


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
