"""hpl_gflops: HPL's useful flops (2/3 n^3 + 3/2 n^2 an item) of every
item in the window over the window's host-clock wall, in GFLOP/s."""


def read(rec):
    return rec["item_flops"] * rec["items"] / rec["window_s"] / 1e9
