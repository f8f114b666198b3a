"""solve.mfu.cold: solve.mfu (the solves' least time over the window's
wall) in the cold cell, whose runs spread far less than the host-paced
cells' and so take a bound of their own."""
from lcsc_bench.lib.spec import reader

read = reader("solve.mfu").read
