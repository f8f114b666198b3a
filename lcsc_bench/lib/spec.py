"""Find a cell's parts by the names in ``BENCHMARK.json``.

* ``workloads/<cell>.json``: the cell's configuration, traffic and
  driver, and ``tiny``, the configuration's keys changed for the CPU
  tests' runs (``tests/conftest.py::tiny_run``);
* ``configs/<config>.json``: the configuration as it is run;
* ``traffic/<traffic>.json``: the traffic mix's parameters;
* ``drivers/<driver>.py``: the entry point the cell drives: a class
  ``Driver(config, traffic, seed, devices)``, ``devices`` the cell's
  cards (``cuda:0`` ... ``cuda:<chips - 1>``), and its method
  ``use_control()`` puts the cell's control in its timed path
  (``control.py``);
* ``metrics/<metric>.py``: one reader for each metric (``read(rec)``);
  a metric that is another's quantity in other cells, under bounds of
  its own, takes that one's reader (``reader``).

A new cell, configuration, traffic mix or metric is a new file here and
an entry in ``BENCHMARK.json``; nothing is edited.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_module(path: Path, prefix: str):
    """Import the file ``path`` (its name may hold dots) as a module."""
    name = prefix + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: Path = BENCH_DIR):
    """The module of ``metrics/<metric>.py``."""
    return load_module(bench_dir / "metrics" / f"{metric}.py",
                       "lcsc_bench_metric_")


def reported(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics ``cell`` prints: the end-to-end ones without
    ``trace``, the per-layer ones with it; a metric with ``workloads``
    only in the cells it lists."""
    return [m for m in bench["end_to_end" if not trace else "per_layer"]
            if "workloads" not in m or cell in m["workloads"]]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    driver: object            # the driver's module
    metrics: list             # [(entry of BENCHMARK.json, reader module)]
    tiny: dict                # the configuration's keys for the CPU tests


def cell(name: str, trace: bool, *, bench: dict | None = None,
         bench_dir: Path = BENCH_DIR) -> Cell:
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = load_json(bench_dir / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if wl[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{wl[key]!r}, BENCHMARK.json {entry[key]!r}")
    metrics = [(m, reader(m["name"], bench_dir))
               for m in reported(bench, name, trace)]
    return Cell(
        name=name, chips=int(entry["chips"]),
        config=load_json(bench_dir / "configs" / f"{wl['config']}.json"),
        traffic=load_json(bench_dir / "traffic" / f"{wl['traffic']}.json"),
        driver=load_module(bench_dir / "drivers" / f"{wl['driver']}.py",
                           "lcsc_bench_driver_"),
        metrics=metrics, tiny=wl.get("tiny", {}))
