"""device_idle.solve.cold: device_idle.solve (the profiled stretch's idle
share) in the cold cell, whose runs spread far less than the host-paced
cells' and so take a bound of their own."""
from lcsc_bench.lib.spec import reader

read = reader("device_idle.solve").read
