"""hpl.mfu: hpl_gflops over the card's f32 peak (67 TFLOP/s, data
sheet), in %.  Read from the window, outside the profiler."""
from lcsc_bench.lib.peaks import PEAK_F32_FLOPS


def read(rec):
    rate = rec["item_flops"] * rec["items"] / rec["window_s"]
    return 100.0 * rate / PEAK_F32_FLOPS
