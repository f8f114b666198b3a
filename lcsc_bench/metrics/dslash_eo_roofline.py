"""dslash_eo_roofline: the bytes bound of the profiled stretch's even-odd
hops (B1, ``dslash_eo_kernel``) over their device time, in %.

Each hop's bytes are counted at the precision the configuration states
for it (``lib/counts.py``): the inner CG's 4 hops a normal operator at
the inner type, the outer rounds' 4 hops each and the right-hand side's
and the odd reconstruction's 2 at the working type.  The count of hops
comes from the program's iteration counters and has to equal the
kernel's launches in the trace; where it does not, or the kernel is not
in the trace, nothing is read.
"""
from lcsc_bench.lib import counts
from lcsc_bench.lib.peaks import HBM_BW
from lcsc_bench.lib.trace import kernel

KERNEL = "dslash_eo_kernel"


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    secs, launches = kernel(tr, KERNEL)
    cfg = rec["config"]
    volume = 1
    for s in cfg["lattice"]:
        volume *= s
    inner = sum(4 * c["inner"] for c in tr["counters"])
    outer = sum(4 * c["outer"] + 2 for c in tr["counters"])
    if launches == 0 or launches != inner + outer:
        return None
    nbytes = (inner * counts.hop_bytes(volume, cfg["solver"]["inner_dtype"])
              + outer * counts.hop_bytes(volume, cfg["dtype"]))
    return 100.0 * nbytes / HBM_BW / secs
