"""The control, the reference in the nearest precision below the
configuration's put in the program's place, comes out not correct; the
program comes out correct.  At the tiny sizes on the CPU; the control's
readings at the cells' sizes come from ``control.py`` on the card."""
import pytest

from lcsc_bench.lib import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def controlled(base):
    class Control(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.use_control()
    return Control


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(tiny_run, name):
    out = tiny_run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_run, name):
    base = spec.cell(name, False).driver.Driver
    out = tiny_run(name, controlled(base))
    assert not out["correct"]
    for c in out["checks"].values():
        assert not c["value"] <= c["limit"]
