"""dslash_eo_roofline.4chip: B1's share of its bytes bound over the cards
of a T-sharded solve, in %: the whole lattice's even-odd hops of the
profiled stretch, each counted at the precision the configuration states
for it (``lib/counts.py``; the inner CG's 4 hops a normal operator at the
inner type, the outer rounds' 4 and the right-hand side's and the odd
reconstruction's 2 at the working type), over one card's HBM rate times
B1's (``dslash_eo_kernel``) device seconds summed over the cards.  Each
hop is one launch a shard, on the shard's T-slab padded with a halo row
on each side; the pad rows' bytes are not counted.  Where the launches
are not the shards times the hops the counters give, or the kernel is
not in the trace, nothing is read."""
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
    if launches == 0 or launches != cfg["mesh"]["shards"] * (inner + outer):
        return None
    nbytes = (inner * counts.hop_bytes(volume, cfg["solver"]["inner_dtype"])
              + outer * counts.hop_bytes(volume, cfg["dtype"]))
    return 100.0 * nbytes / HBM_BW / secs
