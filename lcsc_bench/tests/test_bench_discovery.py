"""Every configuration, traffic mix, cell and metric of BENCHMARK.json
is found by name; a new cell or metric, on one card or four, is found
and run from new files alone."""
import json
import shutil

import pytest

from lcsc_bench.lib import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads(name, trace):
    cell = spec.cell(name, trace)
    assert cell.chips in (1, 4)
    assert cell.tiny, "a cell names its tiny size for the CPU tests"
    assert hasattr(cell.driver, "Driver")
    names = {m["name"] for m, _ in cell.metrics}
    if trace:
        assert names, "a cell reports at least one per-layer metric"
    else:
        assert "setup_s" in names and len(names) >= 2
    for _, reader in cell.metrics:
        assert callable(reader.read)


def test_at_most_a_quarter_of_the_cells_take_four_cards():
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_configs_are_the_files_named():
    for c in BENCH["configs"]:
        cfg = spec.load_json(spec.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_moves_are_reported_where_the_layer_metric_is():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert "workloads" not in moved or cell in moved["workloads"]


def test_a_new_cell_and_metric_need_new_files_only(tmp_path):
    bench_dir = tmp_path / "lcsc_bench"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (bench_dir / "traffic" / "solve-burst.json").write_text(json.dumps(
        {"name": "solve-burst", "warmup_items": 1,
         "profile_seconds": 0.1}))
    (bench_dir / "workloads" / "lqcd-thermal-burst.json").write_text(
        json.dumps({"config": "lqcd-thermal-32c8", "traffic": "solve-burst",
                    "driver": "lqcd_solve"}))
    (bench_dir / "metrics" / "solve.inner_share.py").write_text(
        "def read(rec):\n"
        "    c = rec['counters']\n"
        "    return sum(x['inner'] for x in c) / sum(x['normal_ops'] for x in c)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "lqcd-thermal-burst",
                               "config": "lqcd-thermal-32c8",
                               "traffic": "solve-burst", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "solve.inner_share", "unit": "1",
                               "better": "higher", "source": "program_counter",
                               "layer": "solver", "moves": "solve_ms",
                               "workloads": ["lqcd-thermal-burst"]})
    bench["end_to_end"][0]["workloads"].append("lqcd-thermal-burst")
    cell = spec.cell("lqcd-thermal-burst", True, bench=bench,
                     bench_dir=bench_dir)
    assert cell.traffic["name"] == "solve-burst"
    assert cell.config["lattice"] == [32, 32, 32, 8]
    names = [m["name"] for m, _ in cell.metrics]
    assert "solve.inner_share" in names
    reader = dict((m["name"], r) for m, r in cell.metrics)["solve.inner_share"]
    assert reader.read({"counters": [{"inner": 19, "normal_ops": 22}]}) == \
        pytest.approx(19 / 22)


# a four-card cell from new files: its driver runs the port's T-sharded
# solve over the cell's cards and carries its own control
SHARDED_DRIVER = '''"""The sharded solve over the cell's cards."""
import functools
from pathlib import Path

from lcsc_bench.lib.spec import load_module

one_card = load_module(Path(__file__).with_name("lqcd_solve.py"), "one_")


class Driver(one_card.Driver):
    def __init__(self, cfg, traffic, seed, devices):
        from repro_torch.distributed.sharding import lattice_mesh
        super().__init__(cfg, traffic, seed, devices[:1])
        self.mesh = lattice_mesh(self.lattice[3], len(devices),
                                 devices=devices)
        self.solve = functools.partial(self.solve, mesh=self.mesh)

    def use_control(self):
        self.solve = one_card.LQCDControl()
'''

OUTER_ROUNDS = '''from lcsc_bench.lib.spans import of


def read(rec):
    solves, rounds = of(rec, "lqcd.solve"), of(rec, "lqcd.eo.outer")
    if solves is None or rounds is None:
        return None
    return rounds["count"] / solves["count"]
'''


def four_card_cell(tmp_path):
    """A copy of the benchmark with a four-card cell added from new files
    and new entries alone; its ``(bench, bench_dir)``."""
    bench_dir = tmp_path / "lcsc_bench"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    cfg = spec.load_json(bench_dir / "configs" / "lqcd-cold-32c64.json")
    cfg["name"] = "lqcd-cold-sharded"
    (bench_dir / "configs" / "lqcd-cold-sharded.json").write_text(
        json.dumps(cfg))
    (bench_dir / "workloads" / "lqcd-cold-4card.json").write_text(
        json.dumps({"config": "lqcd-cold-sharded", "traffic": "solve-stream",
                    "driver": "lqcd_sharded",
                    "tiny": {"lattice": [4, 4, 4, 8]}}))
    (bench_dir / "drivers" / "lqcd_sharded.py").write_text(SHARDED_DRIVER)
    (bench_dir / "metrics" / "solve.outer_rounds.py").write_text(
        OUTER_ROUNDS)
    assert all(p.read_bytes() == b for p, b in before.items())
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({
        "name": "lqcd-cold-sharded", "source": "https://arxiv.org/abs/1811.11475",
        "file": "lcsc_bench/configs/lqcd-cold-sharded.json", "reduced": [],
        "why": "test"})
    bench["workloads"].append({"name": "lqcd-cold-4card",
                               "config": "lqcd-cold-sharded",
                               "traffic": "solve-stream", "chips": 4,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("solve_ms", "solve_ms_p95"):
            m["workloads"].append("lqcd-cold-4card")
    bench["per_layer"].append({"name": "solve.outer_rounds", "unit": "count",
                               "better": "lower",
                               "source": "program_counter",
                               "layer": "solver", "moves": "solve_ms",
                               "workloads": ["lqcd-cold-4card"]})
    return bench, bench_dir


def test_a_four_card_cell_runs_from_new_files_alone(tmp_path, tiny_run):
    bench, bench_dir = four_card_cell(tmp_path)
    where = {"bench": bench, "bench_dir": bench_dir}
    cell = spec.cell("lqcd-cold-4card", False, **where)
    assert cell.chips == 4

    for trace in (False, True):
        out = tiny_run("lqcd-cold-4card", trace=trace, **where)
        assert out["correct"], out["checks"]
        listed = {m["name"] for m in spec.reported(bench, "lqcd-cold-4card",
                                                   trace)}
        assert set(out["metrics"]) == listed
        assert out["device"]["count"] == 4
        assert len(out["device"]["memory_peak_bytes_per_card"]) == 4
        if trace:
            assert out["metrics"]["solve.outer_rounds"]["value"] >= 1
            assert len(out["device"]["busy_s_per_card"]) == 4

    class Control(cell.driver.Driver):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.use_control()
    out = tiny_run("lqcd-cold-4card", Control, **where)
    assert not out["correct"]
    assert out["checks"]["residual_max"]["value"] > \
        out["checks"]["residual_max"]["limit"]


def test_a_workload_file_that_disagrees_is_refused(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["traffic"] = "hpl-stream"
    with pytest.raises(ValueError):
        spec.cell(bench["workloads"][0]["name"], False, bench=bench)
