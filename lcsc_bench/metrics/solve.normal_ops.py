"""solve.normal_ops: the mean over the window's solves of the program's
own count of normal operators, inner iterations plus outer rounds
(``EOCGResult.iters + outer_iters``)."""


def read(rec):
    ops = [c["normal_ops"] for c in rec["counters"]]
    return sum(ops) / len(ops) if ops else None
