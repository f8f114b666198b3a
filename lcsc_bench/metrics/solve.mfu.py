"""solve.mfu: the least time of the window's solves (the reference's
count of their bytes at the HBM rate, or of their flops at the f32
peak, whichever is longer; ``lib/counts.py``) over the window's wall,
in %.  Read from the window, outside the profiler."""


def read(rec):
    least = rec.get("item_least_s")
    if least is None or not least == least or not rec["items"]:
        return None
    return 100.0 * least * rec["items"] / rec["window_s"]
