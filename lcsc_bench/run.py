"""Run one cell of ``BENCHMARK.json`` on the CUDA device and print its
result as the last line of standard output.

    python3 lcsc_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, kernels loaded or built, the inputs made, warm-up) is
``setup_s``.  The window then runs the cell's driver item after item (a
solve, a factorization and solve) until ``--seconds`` have passed; the
item in flight then is finished and the window ends with it.
nvidia-smi samples the power of the cell's boards beside it.  The driver
is given the cell's cards, ``cuda:0`` ... ``cuda:<chips - 1>``.  With
``--trace 1`` a profiled stretch of at least ``profile_seconds`` (whole
items, one at least) follows the window.
Each answer is copied into a slot allocated in set-up; once the window
has closed and the peak memory has been read, the kept answers (every
one the slots hold) are judged against the plain reference, and the
metrics are read from the record by ``metrics/<name>.py``.  The result
line's ``device`` gives the peak memory of the fullest card and each
card's beside it, and with ``--trace 1`` the busy seconds (the union of
the cards' activities, as ``device_idle.*`` read it) and each card's.  Its ``kernels_built`` names the kernel
libraries this run built (a checkout's first run, whose ``setup_s`` pays
nvcc).

The run fails, and prints no result, without a CUDA device, with fewer
cards than the cell asks for, when the program cannot be imported, or
when JAX or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# caches of any compiler the program may use, at fixed paths in the
# checkout (the port's own kernels build into build/kernels)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

from lcsc_bench.lib import spec as specs  # noqa: E402
from lcsc_bench.lib.isolation import forbidden_modules  # noqa: E402
from lcsc_bench.lib.seeds import mix  # noqa: E402


class Kept:
    """The window's answers for the check: every one while they fit in
    ``size`` slots, a uniform sample of ``size`` drawn from the seed
    after that (Algorithm R).  The slots are allocated like ``like``
    before the window, so that keeping an answer is one copy on the
    device and allocates nothing."""

    def __init__(self, size: int, seed: int, like):
        self.rng = random.Random(mix(seed, 7))
        self.slots = like.new_empty((size,) + tuple(like.shape))
        self.index: list[int] = []          # the item held in each slot

    def offer(self, i: int, answer) -> None:
        size = self.slots.shape[0]
        if len(self.index) < size:
            k = len(self.index)
            self.index.append(i)
        else:
            k = self.rng.randrange(i + 1)
            if k >= size:
                return
            self.index[k] = i
        self.slots[k].copy_(answer)

    def answers(self) -> dict:
        return {i: self.slots[k] for k, i in enumerate(self.index)}


def kernel_libs() -> set:
    """The program's built kernel libraries in the checkout."""
    return {p.name for p in (ROOT / "build" / "kernels").glob("*.so")}


def memory_peaks(devices, read) -> dict:
    """``memory_peak_bytes``, the peak of the fullest of ``devices`` by
    ``read(device)``, and each card's beside it."""
    peaks = [int(read(d)) for d in devices]
    return {"memory_peak_bytes": max(peaks),
            "memory_peak_bytes_per_card": peaks}


def busy_per_card(traced: dict, chips: int) -> list[float]:
    """The busy seconds of each of the cell's cards, ``0`` ...
    ``chips - 1``, in a profiled stretch (``trace.summarize``)."""
    return [traced["busy_s_by_card"].get(i, 0.0) for i in range(chips)]


def execute(cell, seed: int, seconds: float, trace: bool, *, devices,
            power, t_start: float = T_START) -> dict:
    """Run ``cell`` (a ``spec.Cell``) on ``devices`` (its cards, or CPU
    places) and return the result line's object, with the compared
    numbers under ``checks``.  ``power()`` samples the cards' power."""
    import torch

    from lcsc_bench.lib import trace as traces
    cuda = torch.device(devices[0]).type == "cuda"

    def sync():
        if cuda:
            for d in devices:
                torch.cuda.synchronize(d)

    drv = cell.driver.Driver(cell.config, cell.traffic, seed, devices)
    with power() as ps:
        drv.setup()
        sample = Kept(int(cell.config["check"]["answers"]), seed,
                      drv.answer_like)
        sync()
        setup_s = time.perf_counter() - t_start
        counters: list[dict] = []
        e0, t0 = time.time(), time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = len(counters)
            count, answer = drv.item(i)
            counters.append(count)
            sample.offer(i, answer)
        window_s = time.perf_counter() - t0
        e1 = time.time()
    watts, sm_clock, n_samples, boards = ps.window(e0, e1)
    traced = None
    if trace:
        base = len(counters)
        traced_counters = []
        with traces.profiled(sync) as prof:
            p0 = time.perf_counter()
            while not traced_counters or time.perf_counter() - p0 < float(
                    cell.traffic["profile_seconds"]):
                traced_counters.append(drv.item(base + len(traced_counters))[0])
        traced = traces.summarize(prof["events"], prof["t0_ns"], prof["t1_ns"])
        traced["counters"] = traced_counters
    peaks = memory_peaks(devices, torch.cuda.max_memory_allocated if cuda
                         else lambda d: 0)
    c0 = time.perf_counter()
    kept = sample.answers()
    checks = drv.check(kept)
    work = drv.work(kept)
    check_s = time.perf_counter() - c0
    rec = {"setup_s": setup_s, "window_s": window_s, "items": len(counters),
           "counters": counters, "watts": watts, "joules": watts * window_s,
           "sm_clock_mhz": sm_clock, "power_samples": n_samples,
           "boards": boards,
           "trace": traced, "config": cell.config, **work}
    metrics = {}
    for entry, reader in cell.metrics:
        value = reader.read(rec)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    failed = sum(1 for c in counters if c.get("failed"))
    correct = bool(counters) and failed == 0 and all(
        v <= lim for v, lim in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips, **peaks}
    out = {"correct": correct, "attempted": len(counters), "failed": failed,
           "metrics": metrics, "device": dev}
    if traced is not None:
        dev["busy_s"] = traced["busy_s"]
        dev["busy_s_per_card"] = busy_per_card(traced, cell.chips)
        dev["window_s"] = traced["window_s"]
        out["breakdown"] = traces.breakdown(traced)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    notes = (f"{len(kept)} answers judged; the reference took "
             f"{check_s:.2f} s; {drv.notes(rec)}; boards (W, MHz, "
             f"samples): " + ", ".join(
                 f"{b['board']} {b['watts']:.2f} {b['sm_clock_mhz']:.0f} "
                 f"{b['samples']}" for b in boards))
    if traced is not None:
        walls = [c["wall_s"] for c in traced["counters"]]
        notes += (f"; profiled stretch: {len(walls)} items in "
                  f"{traced['window_s']:.3f} s, mean wall "
                  f"{sum(walls) / len(walls) * 1e3:.3f} ms")
    out["_notes"] = notes
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = specs.cell(args.workload, bool(args.trace))
    libs = kernel_libs()

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this "
              f"process sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from lcsc_bench.lib.power import PowerSamples, boards, card_limit
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    ids = boards(devices)
    out = execute(cell, args.seed, args.seconds, bool(args.trace),
                  devices=devices, power=lambda: PowerSamples(ids))
    bad = forbidden_modules()
    if bad:
        print(f"loaded once the window had closed: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    notes = out.pop("_notes")
    # the run that built the kernels, a checkout's first, pays nvcc in
    # setup_s: marked in the result line and beside the notes
    checks = out.pop("checks")
    out["kernels_built"] = sorted(kernel_libs() - libs)
    out["checks"] = checks
    print(f"card (name, power.limit W): {card_limit(ids)}; kernels built in "
          f"this run: {out['kernels_built'] or 'none'}; {notes}")
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
