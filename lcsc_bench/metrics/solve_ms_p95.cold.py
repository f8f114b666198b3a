"""solve_ms_p95.cold: solve_ms_p95 (the 95th percentile of the window's
solve walls, ms) in the cold cell, whose runs spread far less than the
host-paced cells' and so take a bound of their own."""
from lcsc_bench.lib.spec import reader

read = reader("solve_ms_p95").read
