"""solve.launches_per_iter: the device activities launched a CG iteration
in the profiled stretch: those whose runtime call starts inside an
``lqcd.cg.iter`` span, its normal operator and stopping test included
(``launches_total``), over the iterations.  An activity whose runtime
call the trace lacks is counted under no span (``lib/spans.py``'s
``unmatched``)."""
from lcsc_bench.lib.spans import of


def read(rec):
    it = of(rec, "lqcd.cg.iter")
    return None if it is None else it["launches_total"] / it["count"]
