"""dgemm_roofline: the least time of the profiled runs' trailing updates
(B3, ``gemm_kernel``) over their device time, in %.

Each update C (m x w) -= L (m x k) @ U (k x w) of the configuration's
blocked LU with lookahead (``lib/counts.py``) takes at least its flops at
the f32 peak or its bytes (C read and written, L and U read, in f32) at
the HBM rate, whichever is longer.  The updates' count has to equal the
kernel's launches in the trace; where it does not, or the kernel is not
in the trace, nothing is read.
"""
from lcsc_bench.lib import counts
from lcsc_bench.lib.peaks import least_s
from lcsc_bench.lib.trace import kernel

KERNEL = "gemm_kernel"


def read(rec):
    tr = rec["trace"]
    if tr is None:
        return None
    secs, launches = kernel(tr, KERNEL)
    cfg = rec["config"]
    updates = counts.hpl_updates(cfg["n"], cfg["nb"], cfg["lookahead"])
    runs = len(tr["counters"])
    if launches == 0 or launches != runs * len(updates):
        return None
    least = sum(least_s(counts.gemm_flops(*u), counts.gemm_bytes(*u))
                for u in updates)
    return 100.0 * runs * least / secs
