"""gflops_per_w: the window's counted flops over the joules the board
drew in it (nvidia-smi's power.draw, mean of the samples in the window,
times the window's seconds), in GFLOP/s/W.  LQCD's flops are those the
plain reference needs for the sampled sources (``lib/counts.py``)."""


def read(rec):
    flops = rec["item_flops"] * rec["items"]
    if not flops == flops or rec["joules"] <= 0:     # no reference count
        return None
    return flops / rec["joules"] / 1e9
