"""solve.host_syncs: the program's read-backs to the host a solve in the
profiled stretch: its ``lqcd.host_sync`` spans over its ``lqcd.solve``
spans (``repro_torch.spans``, rolled up by ``lib/spans.py``).  Every
read-back of the solve is in such a span, so this is the host syncs a
solve, a program counter that needs no device."""
from lcsc_bench.lib.spans import of


def read(rec):
    solves, syncs = of(rec, "lqcd.solve"), of(rec, "lqcd.host_sync")
    if solves is None or syncs is None:
        return None
    return syncs["count"] / solves["count"]
