"""Data-sheet peaks of one NVIDIA H100 SXM (dense, no sparsity, at the
full 700 W power limit), copied from ``src/repro_torch/roofline/hw.py``,
and the least-time arithmetic of ``src/repro_torch/kernels/timing.py``
(``bound``): each input read once and each output written once at the
HBM rate, or the operations at the peak rate, whichever takes longer.
The copies sit here so that no change to the program moves the
yardstick.
"""
from __future__ import annotations

PEAK_F32_FLOPS = 67e12         # float32 outside the tensor cores
HBM_BW = 3.35e12               # bytes/s, HBM3
HBM_BYTES = 80e9               # bytes on the card


def least_s(flops: float, nbytes: float) -> float:
    """Least seconds for ``flops`` f32 operations moving ``nbytes``."""
    return max(flops / PEAK_F32_FLOPS, nbytes / HBM_BW)
