"""Multi-device D-slash: the lattice T axis split over the shards of a
:class:`~repro_torch.distributed.LatticeMesh`, with a halo exchange
between neighbouring shards (the paper's multi-GPU lattice mode).

The port of the JAX package's ``lqcd/multichip.py``.  Where the JAX
function runs one ``shard_map`` body per device with ``ppermute``
messages, the port holds each shard's T-block as a tensor on its device
in one process and moves a boundary slice from one shard's tensor to its
neighbour's (:func:`ppermute`): a view on the neighbour's block when both
shards share a device (the copy happens where the halo is consumed), a
``.to(device, non_blocking=True)`` otherwise.

Wire traffic: the Wilson projector ``(1 ∓ γ_t)`` in the Dirac basis is
``diag(0,0,2,2)`` / ``diag(2,2,0,0)``, so only two of the four spin
components of a halo slice ever enter the t hop.  With ``compress=True``
(default) only those two components cross, zero-filled on arrival, and
the result is bit-identical to the full exchange.

Each shard's body is the full-lattice hop on a halo-padded block of
``T_local + 2`` rows (:func:`_dslash_padded_local`): the hand-written
kernel (B2, ``dslash_full_kernel``) on a CUDA tensor, its plain version
(``dslash_split_ref``) on a CPU one, so the CPU runs the padding the card
runs.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import torch

from repro_torch.distributed.sharding import (LatticeMesh, gather_t_blocks,
                                              split_t_blocks)
from repro_torch.kernels.dslash.ops import dslash_op
from repro_torch.spans import LQCD_HALO, span

T_AX = 3


@lru_cache(maxsize=None)
def halo_perms(n: int):
    """Permutation tables of the halo ring of ``n`` shards, as
    ``(src, dst)`` pairs.

    ``fwd`` sends each shard's first T-slice to its predecessor (so every
    shard *receives from its successor*); ``bwd`` the reverse.  Cached per
    shard count.
    """
    fwd = tuple((i, (i - 1) % n) for i in range(n))   # to prev
    bwd = tuple((i, (i + 1) % n) for i in range(n))   # to next
    return fwd, bwd


def ppermute(xs: Sequence[torch.Tensor], perm) -> List[torch.Tensor]:
    """``out[dst] = xs[src]`` for each ``(src, dst)`` of ``perm``, on the
    device of ``xs[dst]``: the port's ``jax.lax.ppermute`` over a list of
    per-shard tensors."""
    out = [None] * len(xs)
    for src, dst in perm:
        dev = xs[dst].device
        x = xs[src]
        out[dst] = x if x.device == dev else x.to(dev, non_blocking=True)
    return out


def _halo_exchange(xs: Sequence[torch.Tensor], t_axis: int):
    """Returns (from_next_first_slice, from_prev_last_slice) per shard."""
    fwd_perm, bwd_perm = halo_perms(len(xs))
    first = [x.narrow(t_axis, 0, 1) for x in xs]
    last = [x.narrow(t_axis, x.shape[t_axis] - 1, 1) for x in xs]
    return ppermute(first, fwd_perm), ppermute(last, bwd_perm)


def send_halos(xs: Sequence[torch.Tensor], projected: bool):
    """The two spinor halos of every shard: (from its successor, from its
    predecessor).  ``projected`` sends only the spin components the t hop
    keeps — 2,3 of the successor's first slice ((1 - γ_t) =
    diag(0,0,2,2)), 0,1 of the predecessor's last ((1 + γ_t) =
    diag(2,2,0,0)) — half the bytes; otherwise the full slices."""
    if not projected:
        return _halo_exchange(xs, T_AX)
    fwd_perm, bwd_perm = halo_perms(len(xs))
    tl = xs[0].shape[T_AX]
    send_f = [x.narrow(T_AX, 0, 1)[..., 2:4, :] for x in xs]
    send_b = [x.narrow(T_AX, tl - 1, 1)[..., 0:2, :] for x in xs]
    return ppermute(send_f, fwd_perm), ppermute(send_b, bwd_perm)


def scatter_spin(v: torch.Tensor, lo: int) -> torch.Tensor:
    """Expand a 2-spin-component field ``(..., 2, 3)`` back to 4 spin
    components, placing it at spin positions ``lo:lo+2`` (zeros elsewhere)."""
    z = torch.zeros(v.shape[:-2] + (4,) + v.shape[-1:], dtype=v.dtype,
                    device=v.device)
    z[..., lo:lo + 2, :] = v
    return z


def _dslash_padded_local(U_loc: torch.Tensor, psi_loc: torch.Tensor,
                         psi_next: torch.Tensor, psi_prev: torch.Tensor,
                         u_prev_last: torch.Tensor) -> torch.Tensor:
    """D-slash body on a T-sharded block, through the full-lattice hop (B2
    on a CUDA tensor, its plain version on a CPU one) on a halo-padded
    block of ``T_local + 2`` rows: the predecessor's last slice, the
    block, the successor's first slice.  Any ``T_local`` works: the full
    hop has no parity pattern for the pad to shift.

    The gauge pad holds only what a real row reads: the predecessor's last
    +t link at pad row 0 (the -t hop of row 1).  Its x/y/z links and pad
    row ``T_local + 1`` are zeros.  The hop's periodic wrap in T lands only
    on the two pad rows, which are cropped, so every real row reads the
    operands the one-device hop reads, in the same order.
    """
    Tl = psi_loc.shape[T_AX]
    g_ax = T_AX + 1                          # T axis of the gauge field
    pad = torch.zeros_like(U_loc.narrow(g_ax, 0, 1))
    pad0 = pad.clone()
    pad0[3] = u_prev_last
    U_pad = torch.cat([pad0, U_loc, pad], g_ax)
    psi_pad = torch.cat([psi_prev, psi_loc, psi_next], T_AX)
    return dslash_op(U_pad, psi_pad).narrow(T_AX, 1, Tl)


def dslash_slabs(Us: Sequence[torch.Tensor],
                 psis: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """D-slash of a field held as T-slabs, slab ``j`` on its shard's
    device: ``Us`` (4, X, Y, Z, T_local, 3, 3), ``psis`` (X, Y, Z,
    T_local, 4, 3), in the shards' order along T.  The spin-projected
    halos and the one link slice the -t hop reads cross between
    neighbours (inside an ``lqcd.halo`` span); each shard runs the full
    hop on its padded block; the result is one slab a shard."""
    with span(LQCD_HALO):
        psi_next, psi_prev = send_halos(psis, projected=True)
        # zero-fill the dropped spin components on arrival
        psi_next = [scatter_spin(h, 2) for h in psi_next]
        psi_prev = [scatter_spin(h, 0) for h in psi_prev]
        tl = psis[0].shape[T_AX]
        u_prev_last = ppermute([u[3].narrow(T_AX, tl - 1, 1) for u in Us],
                               halo_perms(len(Us))[1])
    return [_dslash_padded_local(*args) for args in
            zip(Us, psis, psi_next, psi_prev, u_prev_last)]


def dslash_sharded(U: torch.Tensor, psi: torch.Tensor, mesh: LatticeMesh,
                   compress: bool = True) -> torch.Tensor:
    """D-slash with the lattice T axis split over ``mesh``'s shards.

    Takes and returns global tensors (``U`` (4, X, Y, Z, T, 3, 3), ``psi``
    (X, Y, Z, T, 4, 3), complex64); the result lies on ``psi``'s device.
    ``compress=False`` keeps the full 4-spinor halo exchange and sends
    both boundary link slices, as the JAX function does (the yardstick of
    the bit-compatibility test); the default sends the two spin-projected
    components and the one link slice the -t hop reads.  Each shard
    runs the full-lattice hop on its padded block: the hand-written kernel
    on a CUDA device, the plain version on the CPU.
    """
    Us = split_t_blocks(U, mesh, T_AX + 1)
    psis = split_t_blocks(psi, mesh, T_AX)
    if compress:
        outs = dslash_slabs(Us, psis)
    else:
        psi_next, psi_prev = send_halos(psis, projected=False)
        u_prev_last = _halo_exchange([u[3] for u in Us], T_AX)[1]
        outs = [_dslash_padded_local(*args) for args in
                zip(Us, psis, psi_next, psi_prev, u_prev_last)]
    return gather_t_blocks(outs, T_AX, psi.device)
