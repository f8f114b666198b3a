"""Work counts: the operations and bytes that the configuration's
algorithm needs for its inputs, computed from shapes and from the plain
reference's iteration counts, never from the program's counters.

LQCD (Wilson fermions, even-odd preconditioned, CGNE on A†A with the
Schur operator A = 1 − κ² D_eo D_oe), counted per site of the half
lattice (V/2 sites):

* one even-odd hop: 1320 flops (the standard Wilson D-slash count); it
  reads the source half-field's spinor (24 reals) and the 8 links that
  touch the site (4 × 18 reals at the output parity, 4 × 18 at the
  source parity) once, and writes the output spinor (24 reals): 192
  reals;
* one Schur operator: 2 hops and ψ − κ² d (4 flops a complex number, 12
  numbers; reads two spinors and writes one);
* one normal operator A†A: 2 Schur operators (γ5 is a permutation);
* one CG iteration: one normal operator, two dot products and three
  vector updates (4 flops a complex number each; the dots read 3
  spinors, the updates read 2 and write 1 each);
* the fixed part of a solve: the right-hand side b_e + κ D_eo b_o, its
  normal form A† b', and the odd sites' x_o = b_o + κ D_oe x_e.

HPL: 2/3 n³ + 3/2 n² per factorization and solve (netlib HPL's count),
and the trailing updates of the blocked LU with lookahead, step by step.
"""
from __future__ import annotations

HOP_FLOPS = 1320                  # per output half-site
HOP_REALS = 24 + 8 * 18 + 24      # spinor in, 8 links, spinor out
AXPY_FLOPS = 4 * 12               # one complex spinor, real scalar
AXPY_REALS = 3 * 24               # two spinors read, one written
SCHUR_FLOPS = 2 * HOP_FLOPS + AXPY_FLOPS
SCHUR_REALS = 2 * HOP_REALS + AXPY_REALS
NORMAL_OP_FLOPS = 2 * SCHUR_FLOPS
NORMAL_OP_REALS = 2 * SCHUR_REALS
CG_VECTOR_FLOPS = 5 * 4 * 12      # 2 dots + 3 updates
CG_VECTOR_REALS = (2 + 1 + 3 * 3) * 24
CG_ITER_FLOPS = NORMAL_OP_FLOPS + CG_VECTOR_FLOPS
CG_ITER_REALS = NORMAL_OP_REALS + CG_VECTOR_REALS
# rhs (hop + axpy), its normal form (Schur), the odd reconstruction
SOLVE_FIXED_FLOPS = 2 * (HOP_FLOPS + AXPY_FLOPS) + SCHUR_FLOPS
SOLVE_FIXED_REALS = 2 * (HOP_REALS + AXPY_REALS) + SCHUR_REALS

REAL_BYTES = {"float32": 4, "bfloat16": 2, "float64": 8}


def hop_bytes(volume: int, dtype: str) -> int:
    """Bytes of one even-odd hop on a lattice of ``volume`` sites, at the
    real type ``dtype`` the configuration states for it."""
    return volume // 2 * HOP_REALS * REAL_BYTES[dtype]


def solve_flops(volume: int, normal_ops: float) -> float:
    """Flops of one even-odd CGNE solve that needs ``normal_ops``
    iterations."""
    return volume // 2 * (CG_ITER_FLOPS * normal_ops + SOLVE_FIXED_FLOPS)


def solve_bytes(volume: int, normal_ops: float, inner: str,
                outer: str) -> float:
    """Least bytes of the same solve: every iteration at the inner
    precision the configuration allows, the fixed part at the outer."""
    half = volume // 2
    return (half * CG_ITER_REALS * REAL_BYTES[inner] * normal_ops
            + half * SOLVE_FIXED_REALS * REAL_BYTES[outer])


def hpl_flops(n: int) -> float:
    """HPL's useful flops of one factorization and solve."""
    return 2.0 / 3.0 * n ** 3 + 1.5 * n ** 2


def hpl_updates(n: int, nb: int, lookahead: int) -> list[tuple[int, int, int]]:
    """The trailing updates C (m × w) −= L (m × k) @ U (k × w) of one
    blocked LU, as (m, k, w), in order.  With lookahead the next panel's
    ``nb`` columns are updated first, apart from the rest."""
    out = []
    for k1 in range(nb, n, nb):
        t = n - k1
        if lookahead > 0:
            out.append((t, nb, nb))
            if t > nb:
                out.append((t, nb, t - nb))
        else:
            out.append((t, nb, t))
    return out


def gemm_flops(m: int, k: int, w: int) -> float:
    return 2.0 * m * k * w


def gemm_bytes(m: int, k: int, w: int, real_bytes: int = 4) -> float:
    """C read and written, L and U read, once each."""
    return real_bytes * (2 * m * w + m * k + k * w)
