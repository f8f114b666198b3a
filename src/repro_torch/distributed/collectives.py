"""Collectives over one axis of a single-controller :class:`LMMesh`.

The counterparts of ``lax.all_gather`` (tiled), ``psum``, ``pmean`` and
``psum_scatter`` (tiled) inside a JAX ``shard_map`` body.  A body's
values are a dict that maps each mesh coordinate to its tensor, on the
coordinate's device; a collective along ``axis`` combines the tensors
of each group of coordinates that differ only in their ``axis`` index,
and gives each coordinate of the group the result on its own device.
Sums go in coordinate order; a float type narrower than float32 (the
bfloat16 ``psum`` of ``moe.py:256``) adds in float32 and rounds once to
its own type, as XLA's all-reduce does on the reference's CPU devices
(bit-equal, ``tests/test_torch_sharding.py``).  Members of a group that
share a device share the result tensor.  Everything is built from
differentiable torch ops, so autograd runs through a body.

Each call along an axis of more than one coordinate is logged in
``mesh.calls[(name, axis)]``: its ``count``, and every coordinate's
result bytes (``out_bytes``) and the bytes a ring over its group would
send (``wire_bytes``, whole bytes per coordinate): ``(n - 1)`` blocks
each for ``all_gather``, ``2 (n - 1) / n`` of the tensor for ``psum``
and ``pmean``, ``(n - 1) / n`` for ``psum_scatter``.  ``mesh.traffic``
sums the ring bytes by name; ``roofline.analysis.collective_stats``
reads them per chip.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.distributed.sharding import LMMesh

Coord = Tuple[int, ...]
PerCoord = Dict[Coord, torch.Tensor]


def _groups(mesh: LMMesh, axis: str):
    """The coordinates of each group along ``axis``, in axis order."""
    ax = mesh.axis_names.index(axis)
    seen = {}
    for c in mesh.coords():
        key = c[:ax] + c[ax + 1:]
        seen.setdefault(key, []).append(c)
    return list(seen.values())


def _log(mesh: LMMesh, name: str, axis: str, out: PerCoord,
         wire: int) -> None:
    """One call of ``name`` along ``axis`` into ``mesh.calls``."""
    rec = mesh.calls.setdefault((name, axis), dict.fromkeys(
        ("count", "out_bytes", "wire_bytes"), 0))
    rec["count"] += 1
    rec["out_bytes"] += sum(t.numel() * t.element_size()
                            for t in out.values())
    rec["wire_bytes"] += wire


def _combine(mesh: LMMesh, xs: PerCoord, axis: str, name: str,
             reduce: Callable, wire: float,
             take: Callable = lambda r, j: r) -> PerCoord:
    """``take(reduce(the group's tensors on a device), j)`` for the
    coordinate at index ``j`` of each group, ``reduce`` run once per group
    and device; ``wire`` is the share of a coordinate's tensor that it
    sends."""
    out: PerCoord = {}
    n = mesh.size(axis)
    sent = 0
    for group in _groups(mesh, axis):
        reduced: Dict[torch.device, torch.Tensor] = {}
        for j, c in enumerate(group):
            dev = mesh.device(c)
            if dev not in reduced:
                reduced[dev] = reduce([xs[g].to(dev) for g in group])
            out[c] = take(reduced[dev], j)
            sent += int(wire * xs[c].numel() * xs[c].element_size())
    if n > 1:
        _log(mesh, name, axis, out, sent)
    return out


def _sum(ts: list) -> torch.Tensor:
    wide = ts[0].is_floating_point() and ts[0].element_size() < 4
    total = ts[0].float() if wide else ts[0]
    for t in ts[1:]:
        total = total + t
    return total.to(ts[0].dtype) if wide else total


def all_gather(mesh: LMMesh, xs: PerCoord, axis: str, dim: int) -> PerCoord:
    """Each coordinate gets its group's tensors concatenated along
    ``dim`` in axis order (``all_gather(..., tiled=True)``)."""
    n = mesh.size(axis)
    return _combine(mesh, xs, axis, "all_gather",
                    lambda ts: ts[0] if n == 1 else torch.cat(ts, dim=dim),
                    n - 1)


def psum(mesh: LMMesh, xs: PerCoord, axis: str) -> PerCoord:
    """Each coordinate gets the sum of its group's tensors."""
    n = mesh.size(axis)
    return _combine(mesh, xs, axis, "psum", _sum, 2 * (n - 1) / n)


def pmean(mesh: LMMesh, xs: PerCoord, axis: str) -> PerCoord:
    """Each coordinate gets the mean of its group's tensors (their sum
    over the group's size)."""
    n = mesh.size(axis)
    return _combine(mesh, xs, axis, "pmean", lambda ts: _sum(ts) / n,
                    2 * (n - 1) / n)


def psum_scatter(mesh: LMMesh, xs: PerCoord, axis: str,
                 dim: int) -> PerCoord:
    """The group's sum, cut into ``n`` equal blocks along ``dim``: the
    coordinate at index ``j`` of the axis gets block ``j``
    (``psum_scatter(..., tiled=True)``)."""
    n = mesh.size(axis)

    def take(total, j):
        size = total.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not scatter "
                             f"over {n} coordinates of {axis!r}")
        return total.narrow(dim, j * (size // n), size // n)

    return _combine(mesh, xs, axis, "psum_scatter", _sum, (n - 1) / n, take)
