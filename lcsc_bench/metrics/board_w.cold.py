"""board_w.cold: board_w (the board's mean power.draw over the window) in
the cold cell, whose runs spread far less than the host-paced cells' and
so take a bound of their own."""
from lcsc_bench.lib.spec import reader

read = reader("board_w").read
