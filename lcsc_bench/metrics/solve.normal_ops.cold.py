"""solve.normal_ops.cold: solve.normal_ops (the program's normal operators
a solve) in the cold cell, whose runs spread far less than the host-
paced cells' and so take a bound of their own."""
from lcsc_bench.lib.spec import reader

read = reader("solve.normal_ops").read
