"""Lattice (LQCD) sharding: the T axis split over a 1-D mesh of shards.

The counterpart of the lattice rules of the JAX package's
``distributed/sharding.py`` (``lattice_mesh``, ``lattice_eo_specs``).  A
JAX mesh is single-controller: one process drives every local device
through ``shard_map``.  The port keeps that model: a :class:`LatticeMesh`
is an ordered tuple of shard devices, and one process holds each shard's
T-block as a tensor on its device.  Shards are placed round-robin over
the devices, so one card can hold several shards, as the JAX package's
tests place their shards on virtual CPU devices of one host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


@dataclass(frozen=True)
class LatticeMesh:
    """Shard ``i`` of the lattice's T axis lives on ``devices[i]``."""

    devices: Tuple[torch.device, ...]

    @property
    def n(self) -> int:
        """The shard count (the JAX mesh's axis size)."""
        return len(self.devices)

    @property
    def distinct_devices(self) -> Tuple[torch.device, ...]:
        """The devices the shards sit on, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))


def lattice_mesh(t_extent: int, n_devices: Optional[int] = None, *,
                 devices: Optional[Sequence] = None) -> LatticeMesh:
    """1-D mesh for lattice T-sharding.

    Picks the largest shard count (≤ ``n_devices``, else ≤ the number of
    ``devices``) that divides ``t_extent``, as the JAX function does: the
    halo ring assumes equal local T blocks.  ``devices`` defaults to every
    visible card (``cuda:0 … cuda:k-1``) and raises without one; pass
    ``devices=("cpu",)`` for the CPU.  Shards go round-robin over
    ``devices``: ``lattice_mesh(64, 4)`` on one card is four shards on
    ``cuda:0``.
    """
    if devices is None:
        k = torch.cuda.device_count()
        if k == 0:
            raise RuntimeError(
                "no CUDA device is available; pass devices=('cpu',) to "
                "shard the lattice on the CPU")
        devices = [torch.device("cuda", i) for i in range(k)]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("lattice_mesh needs at least one device")
    if len({d.type for d in devices}) != 1:
        raise ValueError(f"a lattice mesh takes devices of one type, got "
                         f"{devices}")
    avail = n_devices or len(devices)
    n = max(d for d in range(1, avail + 1) if t_extent % d == 0)
    return LatticeMesh(tuple(devices[i % len(devices)] for i in range(n)))


def lattice_eo_specs() -> Tuple[int, int]:
    """(gauge-half, spinor-half) split axes of the compact even-odd layout:
    T is axis 4 of a gauge half ``(4, X/2, Y, Z, T, 3, 3)`` and axis 3 of
    a spinor half ``(X/2, Y, Z, T, 4, 3)`` (the JAX function's
    ``PartitionSpec``\\ s name the same axes)."""
    return 4, 3


def split_t_blocks(x: torch.Tensor, mesh: LatticeMesh,
                   axis: int) -> list:
    """Cut a global tensor into the mesh's equal T-blocks along ``axis``,
    each a contiguous tensor on its shard's device."""
    T = x.shape[axis]
    if T % mesh.n:
        raise ValueError(f"T extent {T} is not divisible by the {mesh.n} "
                         f"shards of the mesh")
    tl = T // mesh.n
    return [x.narrow(axis, i * tl, tl).to(d).contiguous()
            for i, d in enumerate(mesh.devices)]


def gather_t_blocks(blocks: Sequence[torch.Tensor], axis: int,
                    device) -> torch.Tensor:
    """The inverse of :func:`split_t_blocks`: one tensor on ``device``."""
    return torch.cat([b.to(device) for b in blocks], dim=axis)
