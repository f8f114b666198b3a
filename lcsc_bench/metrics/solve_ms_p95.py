"""solve_ms_p95: the 95th percentile of the walls of all the window's
solves, in milliseconds (host clock, call to return), linear between
order statistics."""
import statistics


def read(rec):
    walls = [c["wall_s"] for c in rec["counters"]]
    if len(walls) < 2:
        return walls[0] * 1e3 if walls else None
    return statistics.quantiles(walls, n=100, method="inclusive")[94] * 1e3
