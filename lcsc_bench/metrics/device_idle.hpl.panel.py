"""device_idle.hpl.panel: the share of the profiled stretch of HPL runs
in which the device sat idle while the host was inside an ``hpl.panel``
span (a panel's factorization and swaps), by each idle gap's midpoint,
in %."""
from lcsc_bench.lib.spans import of


def read(rec):
    p = of(rec, "hpl.panel")
    if p is None:
        return None
    return 100.0 * p["idle_total_s"] / rec["trace"]["window_s"]
