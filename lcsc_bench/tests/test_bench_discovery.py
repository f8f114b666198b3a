"""Every configuration, traffic mix, cell and metric of BENCHMARK.json
is found by name; a new cell or metric is found from new files alone."""
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
    assert cell.chips == 1
    assert hasattr(cell.driver, "Driver")
    names = {m["name"] for m, _ in cell.metrics}
    if trace:
        assert names, "a cell reports at least one per-layer metric"
    else:
        assert "setup_s" in names and len(names) >= 2
    for _, reader in cell.metrics:
        assert callable(reader.read)


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


def test_a_workload_file_that_disagrees_is_refused(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["traffic"] = "hpl-stream"
    with pytest.raises(ValueError):
        spec.cell(bench["workloads"][0]["name"], False, bench=bench)
