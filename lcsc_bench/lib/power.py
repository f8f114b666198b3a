"""The power draw of the cell's boards beside the window, from nvidia-smi.

A copy of ``chip_smoke.py``'s ``PowerSamples``: ``nvidia-smi`` samples
every board every 100 ms in a subprocess for as long as the ``with``
block runs and is stopped by SIGINT, which makes it flush and exit.
This copy also asks for each sample's timestamp and board UUID, so that
only the samples inside the measured window, and only those of the
boards the cell uses (matched by UUID, never by index), count.  The
window's watts are each board's mean over the window, summed over the
boards; its SM clock is the mean of the boards' means.  A sampler that
ends early, prints what it was not asked for, or gives one of the
boards fewer than ``MIN_SAMPLES`` samples in the window fails the run.
"""
from __future__ import annotations

import datetime
import signal
import subprocess

QUERY = ["nvidia-smi", "--query-gpu=timestamp,uuid,power.draw,clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "100"]
LIMIT_QUERY = ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
               "--format=csv,noheader,nounits"]
MIN_SAMPLES = 10
STAMP = "%Y/%m/%d %H:%M:%S.%f"


def board_id(uuid) -> str:
    """A board's UUID as nvidia-smi and torch both give it, compared
    alike: lower case, without nvidia-smi's ``GPU-`` prefix."""
    s = str(uuid).strip().lower()
    return s[4:] if s.startswith("gpu-") else s


def boards(devices) -> list[str]:
    """The UUIDs of the CUDA devices ``devices`` (``cuda:0``, ...)."""
    import torch
    return [board_id(torch.cuda.get_device_properties(d).uuid)
            for d in devices]


def card_limit(ids) -> str:
    """Each board's name and power limit, as nvidia-smi gives them, for
    the boards ``ids``."""
    out = subprocess.run(LIMIT_QUERY, capture_output=True, text=True,
                         check=True, timeout=60).stdout
    rows = [line.split(",", 1) for line in out.strip().splitlines()]
    return "; ".join(r[1].strip() for r in rows
                     if len(r) == 2 and board_id(r[0]) in ids)


def parse(out: str) -> list[tuple]:
    """nvidia-smi's lines as (epoch seconds, board, watts, SM MHz)."""
    rows = []
    for line in out.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) != 4:
            raise RuntimeError(f"nvidia-smi gave {line[:200]!r}")
        stamp = datetime.datetime.strptime(parts[0], STAMP).timestamp()
        rows.append((stamp, board_id(parts[1]), float(parts[2]),
                     float(parts[3])))
    return rows


class PowerSamples:
    """``with PowerSamples(ids) as ps: ...``; then ``ps.window(t0, t1)``
    gives the watts and SM clock of the boards ``ids`` between the epoch
    seconds ``t0`` and ``t1``."""

    def __init__(self, ids):
        self.ids = list(ids)
        self.rows: list[tuple] = []

    def __enter__(self) -> "PowerSamples":
        self.smi = subprocess.Popen(QUERY, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *exc) -> None:
        alive = self.smi.poll() is None
        self.smi.send_signal(signal.SIGINT)
        try:
            out, err = self.smi.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.smi.kill()
            out, err = self.smi.communicate(timeout=30)
        if exc[0] is not None:
            return
        if not alive:
            raise RuntimeError(f"nvidia-smi ended before the window did "
                               f"(exit {self.smi.returncode}: {err[:200]!r})")
        self.rows = parse(out)

    def window(self, t0: float, t1: float) -> tuple[float, float, int, list]:
        """Watts (each board's mean, summed over the boards), SM clock
        (MHz, the mean of the boards' means), the fewest samples a board
        has in [t0, t1] (epoch seconds), and each board's record
        (``board``, ``watts``, ``sm_clock_mhz``, ``samples``)."""
        per_board = []
        for b in self.ids:
            inside = [r for r in self.rows if r[1] == b and t0 <= r[0] <= t1]
            n = len(inside)
            if n < MIN_SAMPLES:
                raise RuntimeError(f"nvidia-smi gave board {b} {n} samples "
                                   f"in a {t1 - t0:.2f} s window, fewer "
                                   f"than {MIN_SAMPLES}")
            per_board.append({"board": b,
                              "watts": sum(r[2] for r in inside) / n,
                              "sm_clock_mhz": sum(r[3] for r in inside) / n,
                              "samples": n})
        watts = sum(p["watts"] for p in per_board)
        clock = sum(p["sm_clock_mhz"] for p in per_board) / len(per_board)
        return (watts, clock, min(p["samples"] for p in per_board),
                per_board)
