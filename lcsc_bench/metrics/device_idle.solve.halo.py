"""device_idle.solve.halo: the share of the profiled stretch in which no
card ran anything while the host was inside an ``lqcd.halo`` span (a
sharded hop's halo exchange: the spin-projected boundary slices copied
to the neighbours' cards and padded onto each slab), by each idle gap's
midpoint, in %.  The part of ``device_idle.solve`` that the exchanges
across cards hold."""
from lcsc_bench.lib.spans import of


def read(rec):
    halo = of(rec, "lqcd.halo")
    if halo is None:
        return None
    return 100.0 * halo["idle_total_s"] / rec["trace"]["window_s"]
