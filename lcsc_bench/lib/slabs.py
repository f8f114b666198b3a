"""The benchmark's LQCD inputs made as T-slabs, one slab a device: each
T-row of the field is drawn on its slab's device by ``inputs.py`` from
its own seed, ``mix(seed, t)`` for the global row ``t``, so that the
field is the same however many slabs hold it, and no device ever holds
the whole field."""
from __future__ import annotations

import torch

from lcsc_bench.lib import inputs
from lcsc_bench.lib.seeds import mix


def _rows(lattice, devices):
    """(X, Y, Z), the slabs' T extent and each slab's first row."""
    X, Y, Z, T = (int(s) for s in lattice)
    n = len(devices)
    if T % n:
        raise ValueError(f"T extent {T} is not divisible by {n} slabs")
    ts = T // n
    return (X, Y, Z), ts, [j * ts for j in range(n)]


def su3_field(seed: int, lattice, devices) -> list[torch.Tensor]:
    """The hot-start gauge field of ``inputs.su3_field`` as slabs (4, X,
    Y, Z, T/n, 3, 3) complex64, slab ``j`` on ``devices[j]``."""
    xyz, ts, starts = _rows(lattice, devices)
    out = []
    for t0, d in zip(starts, devices):
        slab = torch.empty((4,) + xyz + (ts, 3, 3), dtype=torch.complex64,
                           device=d)
        for k in range(ts):
            slab[:, :, :, :, k] = inputs.su3_field(
                mix(seed, t0 + k), xyz + (1,), d)[:, :, :, :, 0]
        out.append(slab)
    return out


def spinor(seed: int, lattice, devices) -> list[torch.Tensor]:
    """A Gaussian source of ``inputs.spinor`` as slabs (X, Y, Z, T/n, 4,
    3) complex64, slab ``j`` on ``devices[j]``."""
    xyz, ts, starts = _rows(lattice, devices)
    out = []
    for t0, d in zip(starts, devices):
        slab = torch.empty(xyz + (ts, 4, 3), dtype=torch.complex64, device=d)
        for k in range(ts):
            slab[:, :, :, k] = inputs.spinor(mix(seed, t0 + k), xyz + (1,),
                                             d)[:, :, :, 0]
        out.append(slab)
    return out
