"""Blocked right-looking LU with partial pivoting and HPL-GPU-style
lookahead: the counterpart of the JAX package's ``src/repro/hpl/lu.py``,
computing the same function.

Per block step (HPL-GPU, paper ref [1]):
  1. panel factorization, column by column with row pivoting, the rows
     swapped within the panel's columns; then the panel's swaps applied,
     in order, to the other columns (before anything reads them).  On the
     card each is one hand-written kernel (``kernels/panel``);
  2. the triangular solve for the U block row;
  3. the trailing-matrix update ``A22 -= L21 @ U12``, which on the card is
     the hand-written GEMM kernel (``kernels/dgemm``).
With lookahead, the next panel's columns are updated before the rest of
the trailing matrix, as two GEMMs.

The JAX version keeps the full n x n matrix and masks the active region,
because XLA needs static shapes.  This one works on the active windows;
every term the mask removes is an exact 0 or an unchanged entry, so the
values are the same.  The factorization reads nothing back to the host;
the solve reads the pivots back once.

Spans (``repro_torch.spans``) mark the factorization, each panel, each
U12 solve and each update, and the solve with its permutation and its
triangular solves; they cost one check of the profiler's state each when
no profiler records.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.dgemm.ops import dgemm_update_
from repro_torch.kernels.panel import kernel as panel_kernel
from repro_torch.spans import (HPL_HOST_SYNC, HPL_LU, HPL_PANEL, HPL_SOLVE,
                               HPL_SOLVE_PERM, HPL_SOLVE_TRSV, HPL_TRSM,
                               HPL_UPDATE, HPL_UPDATE_NEXT, HPL_UPDATE_REST,
                               span)


class LUResult(NamedTuple):
    lu: torch.Tensor         # packed L\U (unit lower L below the diagonal)
    piv: torch.Tensor        # (n // nb, nb) int32: row swapped at each column
    n_steps: int


def _panel_factor(a: torch.Tensor, k0: int, nb: int,
                  piv: torch.Tensor) -> None:
    """Factor columns [k0, k0+nb) of ``a`` in place, with partial pivoting
    over rows >= column, swapping the rows within these columns only;
    write the pivot rows to ``piv`` (nb,)."""
    one = torch.ones((), dtype=a.dtype, device=a.device)
    rows = torch.arange(a.shape[0], device=a.device)
    panel = a[:, k0:k0 + nb]
    for j in range(nb):
        col = k0 + j
        # first maximum of |a[col:, col]|, as an absolute row (a tensor)
        p = torch.argmax(a[col:, col].abs()) + col
        piv[j] = p
        swap = torch.stack((rows[col], p))
        panel.index_copy_(0, swap, panel.index_select(0, swap.flip(0)))
        pivot = a[col, col]
        a[col + 1:, col].div_(torch.where(pivot.abs() < 1e-30, one, pivot))
        if j + 1 < nb:
            a[col + 1:, col + 1:k0 + nb].addr_(
                a[col + 1:, col], a[col, col + 1:k0 + nb], alpha=-1)


def _swap_rest(a: torch.Tensor, k0: int, nb: int, piv: torch.Tensor) -> None:
    """Apply the panel's swaps (rows k0 + j and ``piv[j]``), in order, to
    the columns of ``a`` outside [k0, k0+nb)."""
    for j, p in enumerate(piv.tolist()):
        for side in (a[:, :k0], a[:, k0 + nb:]):
            side[[k0 + j, p]] = side[[p, k0 + j]]


def _factor_panel(a: torch.Tensor, k0: int, nb: int,
                  piv: torch.Tensor) -> None:
    """The panel and its swaps: plain on the CPU, the two kernels on the
    card (which raise on what they cannot run)."""
    if a.device.type == "cpu":
        _panel_factor(a, k0, nb, piv)
        _swap_rest(a, k0, nb, piv)
    else:
        panel_kernel.panel_lu_(a, k0, nb, piv)
        panel_kernel.laswp_(a, k0, nb, piv)


def blocked_lu(a: torch.Tensor, nb: int, *, lookahead: int = 1) -> LUResult:
    """LU-factor a (n, n) matrix in blocks of ``nb``; ``a`` is not
    modified."""
    n = a.shape[0]
    if a.dim() != 2 or a.shape[1] != n:
        raise ValueError(f"a must be square, got shape {tuple(a.shape)}")
    if n % nb:
        raise ValueError("n must be a multiple of the block size")
    steps = n // nb
    with span(HPL_LU):
        a = a.clone()
        piv = torch.empty((steps, nb), dtype=torch.int32, device=a.device)
        for k in range(steps):
            k0, k1 = k * nb, (k + 1) * nb
            with span(HPL_PANEL):
                _factor_panel(a, k0, nb, piv[k])
            if k1 == n:
                break
            with span(HPL_TRSM):
                a[k0:k1, k1:] = torch.linalg.solve_triangular(
                    a[k0:k1, k0:k1], a[k0:k1, k1:], upper=False,
                    unitriangular=True)
            l21, u12, a22 = a[k1:, k0:k1], a[k0:k1, k1:], a[k1:, k1:]
            if lookahead > 0:
                with span(HPL_UPDATE_NEXT):
                    dgemm_update_(a22[:, :nb], l21, u12[:, :nb])
                if k1 + nb < n:
                    with span(HPL_UPDATE_REST):
                        dgemm_update_(a22[:, nb:], l21, u12[:, nb:])
            else:
                with span(HPL_UPDATE):
                    dgemm_update_(a22, l21, u12)
    return LUResult(a, piv, steps)


def lu_solve(res: LUResult, b: torch.Tensor, nb: int) -> torch.Tensor:
    """Solve ``A x = b`` (b of shape (n,) or (n, r)) from the packed LU and
    its pivots.  ``nb`` is kept for parity with the JAX package; the
    pivots carry their own shape."""
    n = b.shape[0]
    if res.piv.numel() != n:
        raise ValueError(f"{res.piv.numel()} pivots for {n} rows")
    with span(HPL_SOLVE):
        with span(HPL_SOLVE_PERM):
            # the swaps, applied in order, as one permutation; piv read once
            with span(HPL_HOST_SYNC):
                piv = res.piv.reshape(-1).tolist()
            perm = list(range(n))
            for col, p in enumerate(piv):
                perm[col], perm[p] = perm[p], perm[col]
            pb = b[torch.tensor(perm, device=b.device)]
        with span(HPL_SOLVE_TRSV):
            rhs = pb.unsqueeze(-1) if b.dim() == 1 else pb
            y = torch.linalg.solve_triangular(res.lu, rhs, upper=False,
                                              unitriangular=True)
            x = torch.linalg.solve_triangular(res.lu, y, upper=True)
    return x.squeeze(-1) if b.dim() == 1 else x
