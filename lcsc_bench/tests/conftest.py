"""The benchmark's CPU tests: ``python -m pytest -q lcsc_bench/tests``
from the repository's root.  They put ``src`` and the root on the path
and run every cell at a tiny size on the CPU, with a stand-in for the
power sampler; nothing here needs a card."""
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


class SteadyPower:
    """The power sampler's place on the CPU: 100 W throughout."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def window(self, t0, t1):
        return 100.0, 1500.0, 10, [{"board": "cpu", "watts": 100.0,
                                    "sm_clock_mhz": 1500.0, "samples": 10}]


def tiny_cell(name, trace=False, **where):
    """The cell ``name`` at its tiny size (its workload file's ``tiny``);
    ``where``: ``spec.cell``'s ``bench`` and ``bench_dir``."""
    from lcsc_bench.lib import spec
    cell = spec.cell(name, trace, **where)
    cell.config.update(cell.tiny)
    return cell


@pytest.fixture
def tiny_run():
    """``tiny_run(name, driver_class=None, trace=False, **where)``: run a
    cell at its tiny size on the CPU for half a second, on as many CPU
    places as it asks for cards, optionally with another driver class in
    the cell's place, and return the result object."""
    from lcsc_bench.run import execute

    def go(name, driver_class=None, trace=False, seed=2 ** 33 + 17,
           **where):
        cell = tiny_cell(name, trace, **where)
        if driver_class is not None:
            cell.driver = type("Drivers", (), {"Driver": driver_class})
        return execute(cell, seed, 0.5, trace, devices=["cpu"] * cell.chips,
                       power=SteadyPower, t_start=time.perf_counter())
    return go
