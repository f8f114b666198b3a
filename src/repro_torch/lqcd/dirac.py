"""Wilson-Dirac operator.

D-slash is the sparse stencil at the heart of LQCD (paper §Introduction):

  (D ψ)(x) = Σ_μ [ (1 − γ_μ) U_μ(x) ψ(x+μ̂) + (1 + γ_μ) U†_μ(x−μ̂) ψ(x−μ̂) ]

with periodic boundaries.  The full Wilson operator is M = 1 − κ D.

Fields:
  psi: (X, Y, Z, T, 4, 3) complex64   (spin, color)
  U:   (4, X, Y, Z, T, 3, 3) complex64 (direction-major)

On CUDA tensors ``dslash`` runs the hand-written full-lattice kernel
(:mod:`repro_torch.kernels.dslash`); on CPU tensors it runs the plain
rolls-and-einsums version below.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.dslash.ops import dslash_op

# Dirac gamma matrices (Dirac basis), complex64
_g0 = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 0], [0, 0, 0, -1]],
               np.complex64)
_g1 = np.array([[0, 0, 0, -1j], [0, 0, -1j, 0], [0, 1j, 0, 0],
                [1j, 0, 0, 0]], np.complex64)
_g2 = np.array([[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]],
               np.complex64)
_g3 = np.array([[0, 0, -1j, 0], [0, 0, 0, 1j], [1j, 0, 0, 0],
                [0, -1j, 0, 0]], np.complex64)
GAMMA = torch.from_numpy(np.stack([_g1, _g2, _g3, _g0]))  # order: x, y, z, t
EYE4 = torch.eye(4, dtype=torch.complex64)
# γ5 = γ0 γ1 γ2 γ3 in the Dirac basis: off-diagonal identity blocks
GAMMA5 = torch.tensor([[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0],
                       [0, 1, 0, 0]], dtype=torch.complex64)


def dslash_flops_per_site() -> int:
    """Standard Wilson D-slash flop count (real ops) per lattice site."""
    return 1320


def dslash_bytes_per_site(real_bytes: int = 8,
                          compressed_links: bool = True) -> int:
    """Streaming traffic per site: 8 neighbor spinor loads + read/write of
    the output spinor (24 reals each) + 8 gauge links (8 reals each when
    compressed as CL2QCD stores them, 18 otherwise)."""
    link_reals = 8 if compressed_links else 18
    reals = 8 * 24 + 24 + 24 + 8 * link_reals
    return reals * real_bytes


def mv(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """U_ab psi_sb -> psi_sa."""
    return torch.einsum("...ab,...sb->...sa", u, v)


def mv_dag(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(U^dagger)_ab psi_sb."""
    return torch.einsum("...ba,...sb->...sa", u.conj(), v)


def spin(proj: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("st,...ta->...sa", proj.to(v.device), v)


def gamma5(v: torch.Tensor) -> torch.Tensor:
    """γ5 v.  In this basis γ5 swaps the upper and lower spin pairs, so it
    is applied as that permutation: the same values as the product with
    ``GAMMA5``, without the arithmetic."""
    return torch.roll(v, 2, dims=-2)


def _dslash_plain(U: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(psi)
    for mu in range(4):
        proj_m = EYE4 - GAMMA[mu]               # (1 - γ_mu)
        proj_p = EYE4 + GAMMA[mu]               # (1 + γ_mu)
        u = U[mu]
        # forward: U_mu(x) psi(x+mu)
        out = out + spin(proj_m, mv(u, torch.roll(psi, -1, mu)))
        # backward: U†_mu(x-mu) psi(x-mu)
        out = out + spin(proj_p, mv_dag(torch.roll(u, 1, mu),
                                        torch.roll(psi, 1, mu)))
    return out


def dslash(U: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """Apply D-slash with periodic boundaries: the hand-written kernel on
    the card, the plain version on the CPU."""
    if psi.device.type == "cpu":
        return _dslash_plain(U, psi)
    return dslash_op(U, psi)


def wilson_matvec(U: torch.Tensor, psi: torch.Tensor,
                  kappa: float) -> torch.Tensor:
    """M ψ = ψ − κ D ψ."""
    return psi - kappa * dslash(U, psi)


def wilson_matvec_dagger(U: torch.Tensor, psi: torch.Tensor,
                         kappa: float) -> torch.Tensor:
    """M† ψ via γ5-hermiticity: M† = γ5 M γ5."""
    return gamma5(wilson_matvec(U, gamma5(psi), kappa))


# ---------------------------------------------------------------------------
# Even-odd (red-black) preconditioning (paper: CL2QCD uses it)
# ---------------------------------------------------------------------------

def parity_mask(shape: Tuple[int, int, int, int],
                device="cuda") -> torch.Tensor:
    """Boolean mask, True on even sites ((x+y+z+t) % 2 == 0)."""
    return torch.from_numpy(np.indices(shape).sum(0) % 2 == 0).to(
        resolve_device(device))


def eo_matvec(U: torch.Tensor, psi_e: torch.Tensor, kappa: float,
              mask_e: torch.Tensor) -> torch.Tensor:
    """Even-odd preconditioned operator  A = 1 − κ² D_eo D_oe  acting on
    even-site spinors (odd entries of psi_e are kept zero)."""
    m = mask_e[..., None, None]
    d1 = dslash(U, psi_e).masked_fill(m, 0)       # keep odd part
    d2 = dslash(U, d1).masked_fill(~m, 0)         # back to even
    return psi_e - (kappa * kappa) * d2


# ---------------------------------------------------------------------------
# Dense cross-check helper (tiny lattices only)
# ---------------------------------------------------------------------------

def dslash_dense_matrix(U: torch.Tensor) -> torch.Tensor:
    """Build the explicit dense D-slash matrix by applying it to basis
    vectors — O((V·12)²) memory; use on ≤ 4⁴ lattices in tests."""
    shape = tuple(U.shape[1:5])
    vol = int(np.prod(shape)) * 12
    cols = []
    for i in range(vol):
        e = torch.zeros(vol, dtype=torch.complex64, device=U.device)
        e[i] = 1.0
        cols.append(dslash(U, e.reshape(shape + (4, 3))).reshape(-1))
    return torch.stack(cols, dim=1)
