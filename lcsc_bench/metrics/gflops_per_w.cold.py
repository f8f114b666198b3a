"""gflops_per_w.cold: gflops_per_w (the window's counted flops over its
joules) in the cold cell, whose runs spread far less than the host-paced
cells' and so take a bound of their own."""
from lcsc_bench.lib.spec import reader

read = reader("gflops_per_w").read
