"""device_idle.hpl.solve: the share of the profiled stretch of HPL runs
in which the device sat idle while the host was inside the ``hpl.solve``
span (``lu_solve``: the pivots read back and applied on the host, the
two triangular solves), by each idle gap's midpoint, in %."""
from lcsc_bench.lib.spans import of


def read(rec):
    s = of(rec, "hpl.solve")
    if s is None:
        return None
    return 100.0 * s["idle_total_s"] / rec["trace"]["window_s"]
