"""The control of each cell, and the readings its limits are set from.

The control is the plain reference put in the program's place and
computed in the nearest precision below the configuration's:

* LQCD: the reference's even-odd CGNE with every field rounded through
  bfloat16 (the configuration states float32), given the normal
  operators the configuration allows the program (``max_iters``);
* HPL: the reference's blocked LU with the trailing updates' operands
  rounded to TF32 (the configuration states IEEE float32, TF32 off).

Each driver carries its cell's control: its method ``use_control()``
puts the control in the driver's timed path.  A new cell's control is so
a part of its driver's file.

    python3 lcsc_bench/control.py --workload <cell> --side control \
        --seeds 11 12 13 [--items K]

reads, for each seed, the compared numbers of ``K`` items (by default
``ITEMS``) made as a run makes them, at the cell's own size, with the
program (``--side program``) or the control in the timed path's place.  The benchmark's own runs never
run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

ITEMS = 3


def readings(cell, seed: int, items: int, side: str, devices) -> dict:
    """The compared numbers of ``items`` items of one run's inputs, on
    the cards ``devices``."""
    drv = cell.driver.Driver(cell.config, cell.traffic, seed, devices)
    if side == "control":
        drv.use_control()
    drv.setup()
    kept = {i: drv.item(i)[1] for i in range(items)}
    return {k: v for k, (v, _) in drv.check(kept).items()}


def main(argv=None) -> int:
    from lcsc_bench.lib import spec as specs
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("program", "control"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--items", type=int)
    args = ap.parse_args(argv)
    cell = specs.cell(args.workload, False)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"the control is read on {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    items = args.items or ITEMS
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = readings(cell, seed, items, args.side, devices)
        print(json.dumps({"workload": args.workload, "side": args.side,
                          "seed": seed, "items": items, "readings": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
