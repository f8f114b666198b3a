"""The card's power draw beside the window, from nvidia-smi.

A copy of ``chip_smoke.py``'s ``PowerSamples``: ``nvidia-smi`` samples
every 100 ms in a subprocess for as long as the ``with`` block runs and
is stopped by SIGINT, which makes it flush and exit.  This copy also
asks for each sample's timestamp, so that only the samples inside the
measured window count.  A sampler that ends early, prints what it was
not asked for, or gives fewer than ``MIN_SAMPLES`` samples in the window
fails the run.
"""
from __future__ import annotations

import datetime
import signal
import subprocess

QUERY = ["nvidia-smi", "--query-gpu=timestamp,power.draw,clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "100"]
LIMIT_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader,nounits"]
MIN_SAMPLES = 10
STAMP = "%Y/%m/%d %H:%M:%S.%f"


def card_limit() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(LIMIT_QUERY, capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


class PowerSamples:
    """``with PowerSamples() as ps: ...``; then ``ps.window(t0, t1)``
    gives the mean watts and SM clock of the samples taken between the
    epoch seconds ``t0`` and ``t1``."""

    def __enter__(self) -> "PowerSamples":
        self.smi = subprocess.Popen(QUERY, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
        self.rows = []
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
        for line in out.strip().splitlines():
            parts = [p.strip() for p in line.split(",")]
            if len(parts) != 3:
                raise RuntimeError(f"nvidia-smi gave {line[:200]!r}")
            stamp = datetime.datetime.strptime(parts[0], STAMP).timestamp()
            self.rows.append((stamp, float(parts[1]), float(parts[2])))

    def window(self, t0: float, t1: float) -> tuple[float, float, int]:
        """Mean watts, mean SM clock (MHz) and the number of samples in
        [t0, t1] (epoch seconds)."""
        inside = [r for r in self.rows if t0 <= r[0] <= t1]
        if len(inside) < MIN_SAMPLES:
            raise RuntimeError(f"nvidia-smi gave {len(inside)} samples in a "
                               f"{t1 - t0:.2f} s window, fewer than "
                               f"{MIN_SAMPLES}")
        n = len(inside)
        return (sum(r[1] for r in inside) / n, sum(r[2] for r in inside) / n,
                n)
