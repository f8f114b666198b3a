"""Profile a stretch of one cell's items and print its rollup by the
program's spans (``lib/spans.py``) as one JSON line.

    python3 lcsc_bench/span_rollup.py --workload <cell> --seed <n> \
        [--items <k>]

Set-up is the cell's driver's, warm-up included; then ``--items`` items
(default: as many as the traffic's ``profile_seconds`` take, one at
least) run under ``lib/trace.profiled``, as ``run.py``'s ``--trace 1``
stretch does.  No window, no power samples, no check of the answers.
The rollup is the one ``lib/trace.summarize`` keeps under ``spans``,
which the span metrics read; beside it the line holds ``summarize``'s
busy and window seconds of the same events and the items' counters.  It
fails without as many CUDA devices as the cell asks for.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from lcsc_bench.lib import spec  # noqa: E402


def profile_cell(cell, seed: int, items: int | None, *, devices) -> dict:
    """Set ``cell`` (a ``spec.Cell``) up on ``devices`` and profile
    ``items`` of its items (``None``: the traffic's ``profile_seconds``
    of them)."""
    import torch

    from lcsc_bench.lib import trace

    def sync():
        if torch.device(devices[0]).type == "cuda":
            for d in devices:
                torch.cuda.synchronize(d)

    drv = cell.driver.Driver(cell.config, cell.traffic, seed, devices)
    drv.setup()
    sync()
    seconds = float(cell.traffic["profile_seconds"])
    counters: list[dict] = []

    def more():
        if items is not None:
            return len(counters) < max(items, 1)
        return not counters or time.perf_counter() - p0 < seconds

    with trace.profiled(sync) as prof:
        p0 = time.perf_counter()
        while more():
            counters.append(drv.item(len(counters))[0])
    summary = trace.summarize(prof["events"], prof["t0_ns"], prof["t1_ns"])
    out = summary["spans"]
    out["summarize"] = {"window_s": summary["window_s"],
                        "busy_s": summary["busy_s"]}
    out["counters"] = counters
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--items", type=int, default=None)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload, True)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    out = profile_cell(cell, args.seed, args.items,
                       devices=[f"cuda:{i}" for i in range(cell.chips)])
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
