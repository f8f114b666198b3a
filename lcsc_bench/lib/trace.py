"""Read a ``torch.profiler`` trace: the device's busy time, the device
operations by name, and the device's idle gaps by what the host was
doing.

The idea of ``chip_smoke.py``'s ``device_activity`` (busy time and
activities by name from the profiler's device events), reading the
profiler's raw events instead of its parsed ``events()``: the parsed
tree costs tens of seconds for the few hundred thousand launches of one
HPL factorization.  Times are the profiler's, in epoch nanoseconds.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

HOST_BETWEEN_OPS = "host between ops"


@contextmanager
def profiled(sync):
    """Profile the block (host and device activities).  Yields a dict
    that holds, after the block, the stretch's host-clock bounds (epoch
    ns) and the profiler's raw events.  ``sync()`` waits for the device
    at both ends."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sync()
        out["t0_ns"] = time.time_ns()
        yield out
        sync()
        out["t1_ns"] = time.time_ns()
    out["events"] = prof.profiler.kineto_results.events()


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(events, t0_ns: int, t1_ns: int) -> dict:
    """``window_s`` (the stretch), ``busy_s`` (the union of the device
    activities inside it, over every card), ``busy_s_by_card`` ({card
    index: the union of that card's activities}), ``ops`` ({name:
    [seconds, count]} of device activities), ``gaps`` ({label: seconds}
    of idle time, labelled by the innermost host operation that ran at
    the middle of each gap, or ``HOST_BETWEEN_OPS``; a program span is a
    host operation, so spans label the gaps they hold) and ``spans``
    (``lib/spans.py``'s rollup of the same events).  A device-typed user
    annotation (kineto's ``gpu_user_annotation`` range) is no device
    activity and is skipped."""
    from torch.autograd import DeviceType

    from lcsc_bench.lib.spans import rollup
    dev, host = [], []
    by_card: dict[int, list] = {}
    ops: dict[str, list] = {}
    for e in events:
        s = e.start_ns()
        d = e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            iv = (max(s, t0_ns), min(s + d, t1_ns))
            dev.append(iv)
            by_card.setdefault(e.device_index(), []).append(iv)
            rec = ops.setdefault(e.name(), [0.0, 0])
            rec[0] += d / 1e9
            rec[1] += 1
        elif d > 0:
            host.append((s, s + d, e.name()))
    busy = _merge([iv for iv in dev if iv[1] > iv[0]])
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    labels: dict[str, float] = {}
    host.sort()
    stack: list = []
    j = 0
    for s, e in gaps:
        mid = (s + e) // 2
        while j < len(host) and host[j][0] <= mid:
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        # nested operations: what is left on top is the innermost one
        # running at ``mid``, unless one that ended below it was skipped
        label = HOST_BETWEEN_OPS
        for op in reversed(stack):
            if op[0] <= mid < op[1]:
                label = op[2]
                break
        labels[label] = labels.get(label, 0.0) + (e - s) / 1e9
    return {"window_s": (t1_ns - t0_ns) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "busy_s_by_card": {
                card: sum(e - s for s, e in _merge(
                    [iv for iv in ivs if iv[1] > iv[0]])) / 1e9
                for card, ivs in sorted(by_card.items())},
            "ops": ops, "gaps": labels,
            "spans": rollup(events, t0_ns, t1_ns)}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the ``top`` device operations by
    time and the ``top`` idle labels by time, each [name, seconds]."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1][0])[:top]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v[0]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}


def kernel(summary: dict, part: str) -> tuple[float, int]:
    """Seconds and launches of the device operations whose name holds
    ``part``."""
    secs, count = 0.0, 0
    for name, (s, c) in summary["ops"].items():
        if part in name:
            secs += s
            count += c
    return secs, count
