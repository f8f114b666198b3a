"""Render the dry-run sweep into the roofline table: a copy of the JAX
package's ``roofline/report.py``.

The port's records (``launch/dryrun.py``) keep the reference's keys, so
either package's report renders either package's records.  As in the
reference, ``pick_hillclimb_cells`` raises when no decode cell is ok.

Usage: PYTHONPATH=src python -m repro_torch.roofline.report [DIR]
(default ``experiments/dryrun_torch``)."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional


def load_cells(dryrun_dir: Path, mesh: str = "pod1",
               variant: str = "baseline") -> List[dict]:
    cells = []
    for f in sorted(dryrun_dir.glob(f"*--{mesh}--{variant}.json")):
        cells.append(json.loads(f.read_text()))
    return cells


def fmt_s(x: Optional[float]) -> str:
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def markdown_table(cells: List[dict]) -> str:
    hdr = ("| arch | shape | status | compute | memory | collective | "
           "dominant | useful | frac | HBM GiB | fits |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for c in cells:
        if c["status"] == "skip":
            lines.append(f"| {c['arch']} | {c['shape']} | SKIP | - | - | - "
                         f"| - | - | - | - | - |")
            continue
        if c["status"] != "ok":
            lines.append(f"| {c['arch']} | {c['shape']} | ERROR | | | | | "
                         f"| | | |")
            continue
        r = c["roofline"]
        hbm = c["memory"].get("total_hbm_bytes", 0) / 2**30
        frac = r.get("bw_useful_ratio") or r.get("roofline_fraction")
        lines.append(
            f"| {c['arch']} | {c['shape']} | ok | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
            f"| {r['dominant']} | {r['useful_ratio']:.2f} "
            f"| {frac:.3f} | {hbm:.1f} | "
            f"{'Y' if c.get('fits_hbm') else 'N'} |")
    return "\n".join(lines)


def pick_hillclimb_cells(cells: List[dict]) -> Dict[str, dict]:
    ok = [c for c in cells if c["status"] == "ok"]
    worst = min(ok, key=lambda c: (c["roofline"].get("bw_useful_ratio")
                                   or c["roofline"]["roofline_fraction"]))
    coll = max(ok, key=lambda c: c["roofline"]["collective_s"]
               / max(c["roofline"]["step_lower_bound_s"], 1e-12))
    decode = [c for c in ok if c["shape"] in ("decode_32k", "long_500k")]
    paper_rep = max(decode, key=lambda c: c["roofline"]["memory_s"])
    return {"worst_fraction": worst, "most_collective": coll,
            "paper_representative": paper_rep}


if __name__ == "__main__":
    import sys
    d = Path(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch")
    cells = load_cells(d)
    print(markdown_table(cells))
    picks = pick_hillclimb_cells(cells)
    print()
    for k, c in picks.items():
        print(f"{k}: {c['arch']} x {c['shape']}")
