"""dslash_eo_roofline.cold: dslash_eo_roofline (B1's bytes bound over its
profiled time) in the cold cell, whose runs spread far less than the
host-paced cells' and so take a bound of their own."""
from lcsc_bench.lib.spec import reader

read = reader("dslash_eo_roofline").read
