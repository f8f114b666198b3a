"""device_idle.solve.cg_update: the share of the profiled stretch in
which the device sat idle while the host was inside an ``lqcd.cg.iter``
span but outside its ``lqcd.normal_op``: the iteration's vector updates,
dots and stopping test with its read-back, by each idle gap's midpoint,
in %."""
from lcsc_bench.lib.spans import of


def read(rec):
    it, op = of(rec, "lqcd.cg.iter"), of(rec, "lqcd.normal_op")
    if it is None or op is None:
        return None
    return (100.0 * (it["idle_total_s"] - op["idle_total_s"])
            / rec["trace"]["window_s"])
