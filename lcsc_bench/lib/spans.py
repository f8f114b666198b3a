"""Roll a profiled stretch up by the program's spans.

The program (``repro_torch.spans``) marks its solver and LU steps with
records named ``lqcd.*`` and ``hpl.*``, which the profiler keeps among
its host events, on the clock of the device's events.  For each span
name, over the stretch [t0, t1]:

* ``count``: the spans;
* ``total_s``: their durations; ``self_s``: each duration less the part
  its child spans cover (a span's parent is the span open around it);
* ``idle_s``: the device's idle gaps whose midpoint falls in the span as
  the innermost program span (the midpoint rule of ``trace.summarize``'s
  idle labels); ``idle_total_s``: the gaps under the span, its child
  spans' included;
* ``launches``: device activities whose host runtime call (the CUDA
  runtime or driver call with their correlation id) starts in the span
  as the innermost program span; ``launches_total``: its child spans'
  included.

``outside`` holds the idle seconds and the launches under no program
span, so idle under every name's ``idle_s`` plus ``outside``'s is the
stretch's idle.  A device-typed user annotation (kineto's
``gpu_user_annotation`` range) is not device activity: it enters
neither the busy time nor the launches.  ``unmatched`` counts device
activities whose runtime call is not in the trace; where it is not 0,
the launch counts are not exact.  One sort of the spans, then a binary
search per gap and per launch: HPL's stretch holds ~10^6 of each.
"""
from __future__ import annotations

from bisect import bisect_right

from lcsc_bench.lib.trace import _merge

PREFIXES = ("lqcd.", "hpl.")
# CUDA runtime (cudaLaunchKernel, cudaMemcpyAsync, ...) and driver
# (cuLaunchKernel, ...) calls, by name: torch 2.11's events have no
# activity type
RUNTIME = "cu"


def rollup(events, t0_ns: int, t1_ns: int) -> dict:
    from torch.autograd import DeviceType
    spans, dev, runtime = [], [], {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(e)
        elif e.name().startswith(PREFIXES):
            s = e.start_ns()
            spans.append((s, s + e.duration_ns(), e.name()))
        elif e.name().startswith(RUNTIME):
            runtime[e.correlation_id()] = e.start_ns()

    # parents, and the innermost span from each boundary on
    spans.sort(key=lambda sp: (sp[0], -sp[1]))
    parent = [-1] * len(spans)
    covered = [0] * len(spans)            # ns its child spans cover
    at, who = [], []
    stack: list[int] = []

    def close_until(t):
        while stack and spans[stack[-1]][1] <= t:
            j = stack.pop()
            at.append(spans[j][1])
            who.append(stack[-1] if stack else -1)

    for i, (s, e, _) in enumerate(spans):
        close_until(s)
        if stack:
            parent[i] = stack[-1]
            covered[stack[-1]] += e - s
        stack.append(i)
        at.append(s)
        who.append(i)
    close_until(float("inf"))

    def innermost(t):
        k = bisect_right(at, t) - 1
        return who[k] if k >= 0 else -1

    busy = _merge([iv for iv in ((max(e.start_ns(), t0_ns),
                                  min(e.start_ns() + e.duration_ns(), t1_ns))
                                 for e in dev) if iv[1] > iv[0]])
    edges = [t0_ns] + [x for iv in busy for x in iv] + [t1_ns]
    idle = [0] * (len(spans) + 1)           # the last slot: under none
    for k in range(0, len(edges), 2):
        s, e = edges[k], edges[k + 1]
        if e > s:
            idle[innermost((s + e) // 2)] += e - s
    launches = [0] * (len(spans) + 1)
    unmatched = 0
    for e in dev:
        t = runtime.get(e.correlation_id())
        if t is None:
            unmatched += 1
        else:
            launches[innermost(t)] += 1

    # a child comes after its parent in the sorted order
    n = len(spans)
    idle_total, launches_total = idle[:n], launches[:n]
    for i in range(n - 1, -1, -1):
        if parent[i] >= 0:
            idle_total[parent[i]] += idle_total[i]
            launches_total[parent[i]] += launches_total[i]
    names: dict[str, dict] = {}
    for i, (s, e, name) in enumerate(spans):
        r = names.setdefault(name, dict.fromkeys(
            ("count", "total_s", "self_s", "idle_s", "idle_total_s",
             "launches", "launches_total"), 0))
        r["count"] += 1
        r["total_s"] += (e - s) / 1e9
        r["self_s"] += (e - s - covered[i]) / 1e9
        r["idle_s"] += idle[i] / 1e9
        r["idle_total_s"] += idle_total[i] / 1e9
        r["launches"] += launches[i]
        r["launches_total"] += launches_total[i]
    busy_ns = sum(e - s for s, e in busy)
    return {"window_s": (t1_ns - t0_ns) / 1e9, "busy_s": busy_ns / 1e9,
            "idle_s": (t1_ns - t0_ns - busy_ns) / 1e9, "spans": names,
            "outside": {"idle_s": idle[n] / 1e9, "launches": launches[n]},
            "unmatched": unmatched}


def of(rec: dict, name: str) -> dict | None:
    """The rollup's record of the span ``name`` in a run record's
    profiled stretch (``rec["trace"]["spans"]``, made by
    ``trace.summarize``), or None where the run was not traced or the
    stretch holds no such span."""
    tr = rec.get("trace")
    if tr is None:
        return None
    r = tr["spans"]["spans"].get(name)
    return r if r and r["count"] else None
