"""device_idle.solve.normal_op: the share of the profiled stretch in
which the device sat idle while the host was inside an
``lqcd.normal_op`` span (the CG iteration's matvec: bf16 rounding, the
gamma5 rolls, four B1 hops), by each idle gap's midpoint, in %.  The
part of ``device_idle.solve`` that the normal operator's launches
hold."""
from lcsc_bench.lib.spans import of


def read(rec):
    op = of(rec, "lqcd.normal_op")
    if op is None:
        return None
    return 100.0 * op["idle_total_s"] / rec["trace"]["window_s"]
