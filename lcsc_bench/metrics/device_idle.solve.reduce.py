"""device_idle.solve.reduce: the share of the profiled stretch in which
no card ran anything while the host was inside an ``lqcd.reduce`` span
(the shards' partial dot products summed across cards), by each idle
gap's midpoint, in %.  The part of ``device_idle.solve`` that the
cross-card reductions hold."""
from lcsc_bench.lib.spans import of


def read(rec):
    red = of(rec, "lqcd.reduce")
    if red is None:
        return None
    return 100.0 * red["idle_total_s"] / rec["trace"]["window_s"]
