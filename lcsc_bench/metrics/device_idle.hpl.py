"""device_idle.hpl: the share of the profiled stretch of HPL runs in
which no device activity ran, in %.  The program spans that hold its
gaps label them: ``device_idle.hpl.*`` and the result line's
``breakdown``."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
