"""solve_ms.cold: solve_ms (the window's wall over its solves, ms) in the
cold cell, whose runs spread far less than the host-paced cells' and so
take a bound of their own."""
from lcsc_bench.lib.spec import reader

read = reader("solve_ms").read
