"""The plain reference of the HPL cell: HPL's scaled residual in float64,
and a plain blocked LU with partial pivoting for the control.

    scaled residual = ‖A x − b‖∞ / (‖A‖∞ ‖x‖∞ n ε),  ε = 2⁻²³ (float32)

The LU takes each panel's factorization and pivots from
``torch.linalg.lu_factor``, the block row from a triangular solve, and
the trailing update from a matrix product.  ``tf32=True`` rounds the
update's operands to TF32 (10 bits of mantissa, to nearest) before the
product, as TF32 tensor cores do: the nearest precision below the
configuration's IEEE float32 with TF32 off.  Nothing of the program is
imported or read.
"""
from __future__ import annotations

import torch

EPS_F32 = 2.0 ** -23
ROWS = 4096                         # rows of A in float64 at a time


def scaled_residual(a: torch.Tensor, x: torch.Tensor,
                    b: torch.Tensor) -> float:
    """HPL's scaled residual of ``x`` for ``a x = b``, in float64."""
    n = a.shape[0]
    xd = x.double()
    r_inf = a_inf = 0.0
    for i in range(0, n, ROWS):
        blk = a[i:i + ROWS].double()
        r_inf = max(r_inf, float((blk @ xd - b[i:i + ROWS].double())
                                 .abs().max()))
        a_inf = max(a_inf, float(blk.abs().sum(1).max()))
    return r_inf / (a_inf * float(xd.abs().max()) * n * EPS_F32)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32's 10-bit mantissa, to nearest even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def lu_solve(a: torch.Tensor, b: torch.Tensor, nb: int, *,
             tf32: bool = False) -> torch.Tensor:
    """Solve a x = b by a right-looking blocked LU with partial pivoting
    (``a`` is not modified)."""
    n = a.shape[0]
    a = a.clone()
    perm = torch.arange(n, device=a.device)
    for k0 in range(0, n, nb):
        k1 = min(k0 + nb, n)
        lu, piv = torch.linalg.lu_factor(a[k0:, k0:k1])
        # the panel's swaps, in order, as one permutation of rows k0..n
        rows = list(range(n - k0))
        for j, p in enumerate((piv - 1).tolist()):
            rows[j], rows[p] = rows[p], rows[j]
        order = torch.tensor(rows, device=a.device)
        a[k0:] = a[k0:][order]
        perm[k0:] = perm[k0:][order]
        a[k0:, k0:k1] = lu
        if k1 == n:
            break
        a[k0:k1, k1:] = torch.linalg.solve_triangular(
            a[k0:k1, k0:k1], a[k0:k1, k1:], upper=False, unitriangular=True)
        left, top = a[k1:, k0:k1], a[k0:k1, k1:]
        if tf32:
            left, top = round_tf32(left), round_tf32(top)
        a[k1:, k1:] -= left @ top
    y = torch.linalg.solve_triangular(a, b[perm].unsqueeze(-1), upper=False,
                                      unitriangular=True)
    return torch.linalg.solve_triangular(a, y, upper=True).squeeze(-1)
