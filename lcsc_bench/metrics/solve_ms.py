"""solve_ms: the window's host-clock wall over the solves completed in
it, in milliseconds."""


def read(rec):
    return rec["window_s"] / rec["items"] * 1e3 if rec["items"] else None
