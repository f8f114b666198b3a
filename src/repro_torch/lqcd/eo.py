"""Even-odd (red-black) site decomposition of the Wilson operator.

The paper's solver-level bandwidth optimization (§Introduction, CL2QCD):
color the lattice by site parity p = (x+y+z+t) mod 2.  D-slash only couples
opposite parities, so in the parity basis the Wilson operator is

    M = [[ 1,        -kappa D_eo ],
         [ -kappa D_oe,        1 ]]

and the Schur complement of the odd block,

    A = M_ee - M_eo M_oo^{-1} M_oe = 1 - kappa^2 D_eo D_oe ,

acts on even sites only.  Solving A x_e = b_e + kappa D_eo b_o and
reconstructing x_o = b_o + kappa D_oe x_e is exactly equivalent to solving
M x = b, with every CG vector half as long.

Compact storage ("checkerboard" layout along x, X even):

    half[i, y, z, t] = full[2*i + ((y + z + t + p) % 2), y, z, t]

so each half-field has shape (X//2, Y, Z, T, ...).  In this layout the
y/z/t hops of D-slash are plain rolls and the x hops a roll that applies
only where s = (y+z+t+p) % 2 says the neighbour wrapped past a cell
boundary.  Parities are 0 = even, 1 = odd.

On CUDA tensors ``dslash_half`` runs the hand-written even-odd kernel
(:mod:`repro_torch.kernels.dslash`); on CPU tensors, the plain version
below.  On CUDA tensors ``schur_matvec`` and ``schur_matvec_dagger`` are
each two launches of that kernel, which folds the rounding, gamma5 and
the Schur axpy into its loads and stores; on CPU tensors they are the
composition ``schur_composed``, which the kernel matches bit for bit.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels.dslash.ops import dslash_half_op, schur_op
from repro_torch.lqcd.dirac import EYE4, GAMMA, gamma5, mv, mv_dag, spin

PROJ_M = torch.stack([EYE4 - GAMMA[mu] for mu in range(4)])  # (1 - gamma_mu)
PROJ_P = torch.stack([EYE4 + GAMMA[mu] for mu in range(4)])  # (1 + gamma_mu)


def _sublattice_offset(shape: Tuple[int, ...], parity: int) -> np.ndarray:
    """s(y,z,t) = (y+z+t+parity) % 2 — the x offset of the first site of
    ``parity`` on each (y,z,t) line.  Shape (1, Y, Z, T)."""
    _, Y, Z, T = shape[:4]
    y, z, t = np.indices((Y, Z, T))
    return ((y + z + t + parity) % 2)[None]


@functools.lru_cache(maxsize=64)
def _pack_index(shape: Tuple[int, int, int, int], parity: int,
                device: torch.device) -> torch.Tensor:
    """Flat full-lattice site index of each compact ``parity`` site, in
    compact order; built once per (shape, parity, device)."""
    X, Y, Z, T = shape
    x = 2 * np.arange(X // 2)[:, None, None, None] \
        + _sublattice_offset(shape, parity)
    y, z, t = np.indices((Y, Z, T))
    flat = ((x * Y + y[None]) * Z + z[None]) * T + t[None]
    return torch.from_numpy(flat.reshape(-1)).to(device)


@functools.lru_cache(maxsize=64)
def _s_out(shape: Tuple[int, int, int, int], parity: int,
           device: torch.device) -> torch.Tensor:
    return torch.from_numpy(
        _sublattice_offset(shape, parity)[0].astype(bool)).to(device)


def _site_shape(t: torch.Tensor, lead: int = 0) -> Tuple[int, ...]:
    return tuple(int(d) for d in t.shape[lead:lead + 4])


def eo_pack(field: torch.Tensor, parity: int) -> torch.Tensor:
    """Gather the ``parity`` sites of a full-lattice field (site axes lead)
    into the compact (X//2, Y, Z, T, ...) layout."""
    shape = _site_shape(field)
    X = shape[0]
    if X % 2:
        raise ValueError(
            f"even-odd packing needs an even x extent, got X={X}")
    idx = _pack_index(shape, parity, field.device)
    rest = tuple(field.shape[4:])
    flat = field.reshape((-1,) + rest).index_select(0, idx)
    return flat.reshape((X // 2,) + shape[1:] + rest)


def eo_unpack(half_e: torch.Tensor, half_o: torch.Tensor) -> torch.Tensor:
    """Interleave compact even/odd half-fields back into a full field."""
    Xh, Y, Z, T = _site_shape(half_e)
    shape = (2 * Xh, Y, Z, T)
    rest = tuple(half_e.shape[4:])
    full = torch.empty((2 * Xh * Y * Z * T,) + rest, dtype=half_e.dtype,
                       device=half_e.device)
    for parity, half in ((0, half_e), (1, half_o)):
        full.index_copy_(0, _pack_index(shape, parity, half.device),
                         half.reshape((-1,) + rest))
    return full.reshape(shape + rest)


def pack_gauge(U: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a (4, X, Y, Z, T, 3, 3) gauge field into per-parity halves of
    shape (4, X//2, Y, Z, T, 3, 3)."""
    return (torch.stack([eo_pack(U[mu], 0) for mu in range(4)]),
            torch.stack([eo_pack(U[mu], 1) for mu in range(4)]))


def hops_spatial(U_out: torch.Tensor, U_src: torch.Tensor, psi: torch.Tensor,
                 s_out: torch.Tensor) -> torch.Tensor:
    """x/y/z hop contributions of one parity block (compact layout); plain
    version.  ``s_out`` is the output-parity offset pattern, (Y, Z, T)."""
    cond = s_out[..., None, None].bool()
    # x direction: s-conditional rolls for spinors and the backward link;
    # the -x link sits at the source site = the bwd neighbour's own site
    psi_fwd = torch.where(cond, torch.roll(psi, -1, 0), psi)
    psi_bwd = torch.where(cond, psi, torch.roll(psi, 1, 0))
    u_bwd_x = torch.where(cond, U_src[0], torch.roll(U_src[0], 1, 0))
    out = spin(PROJ_M[0], mv(U_out[0], psi_fwd))
    out = out + spin(PROJ_P[0], mv_dag(u_bwd_x, psi_bwd))

    # y/z directions: plain rolls (axis 1..2 of the compact layout)
    for mu in (1, 2):
        out = out + spin(PROJ_M[mu], mv(U_out[mu], torch.roll(psi, -1, mu)))
        out = out + spin(PROJ_P[mu], mv_dag(torch.roll(U_src[mu], 1, mu),
                                            torch.roll(psi, 1, mu)))
    return out


def dslash_half(U_out: torch.Tensor, U_src: torch.Tensor, psi: torch.Tensor,
                src_parity: int) -> torch.Tensor:
    """One parity block of D-slash: input ``psi`` lives on ``src_parity``
    sites, output on the opposite parity.  ``U_out``/``U_src`` are the
    packed gauge halves of the output/source parity.  The hand-written
    kernel on the card, the plain version on the CPU.
    """
    if psi.device.type != "cpu":
        U_e, U_o = (U_src, U_out) if src_parity == 0 else (U_out, U_src)
        return dslash_half_op(U_e, U_o, psi, src_parity)
    Xh, Y, Z, T = _site_shape(psi)
    s_out = _s_out((2 * Xh, Y, Z, T), 1 - src_parity, psi.device)
    out = hops_spatial(U_out, U_src, psi, s_out)
    # t direction: plain rolls (axis 3 of the compact layout)
    mu = 3
    out = out + spin(PROJ_M[mu], mv(U_out[mu], torch.roll(psi, -1, mu)))
    out = out + spin(PROJ_P[mu], mv_dag(torch.roll(U_src[mu], 1, mu),
                                        torch.roll(psi, 1, mu)))
    return out


def _round_complex(v: torch.Tensor, dtype) -> torch.Tensor:
    """Round a complex field through a reduced-precision real dtype.

    torch has no complex bfloat16, so reduced precision is emulated by
    rounding the re/im planes through ``dtype`` (round to nearest even) —
    the storage/traffic model of CL2QCD's low-precision inner solver —
    while arithmetic stays f32."""
    if dtype is None:
        return v
    if dtype.is_complex:
        return v.to(dtype)
    return torch.view_as_complex(torch.view_as_real(v).to(dtype).float())


def schur_composed(U_e: torch.Tensor, U_o: torch.Tensor, psi_e: torch.Tensor,
                   kappa: float, *, dagger: bool = False,
                   inner_dtype=None) -> torch.Tensor:
    """``schur_matvec`` (``dagger`` False) or ``schur_matvec_dagger`` as
    the composition of two ``dslash_half`` hops, the roundings through
    ``inner_dtype``, gamma5 and the axpy: the path on the CPU, and on the
    card (plain hops) the yardstick of the fused kernel."""
    p = gamma5(psi_e) if dagger else _round_complex(psi_e, inner_dtype)
    d_oe = dslash_half(U_o, U_e, p, src_parity=0)       # even -> odd
    d_eo = dslash_half(U_e, U_o, d_oe, src_parity=1)    # odd -> even
    out = p - (kappa * kappa) * d_eo
    return _round_complex(gamma5(out) if dagger else out, inner_dtype)


def schur_matvec(U_e: torch.Tensor, U_o: torch.Tensor, psi_e: torch.Tensor,
                 kappa: float, inner_dtype=None) -> torch.Tensor:
    """A psi_e = (1 - kappa^2 D_eo D_oe) psi_e on the even half-lattice.

    With ``inner_dtype``, psi_e and the result are rounded through it: the
    first half of the inner CG's normal operator."""
    if psi_e.device.type != "cpu":
        return schur_op(U_e, U_o, psi_e, kappa, inner_dtype=inner_dtype)
    return schur_composed(U_e, U_o, psi_e, kappa, inner_dtype=inner_dtype)


def schur_matvec_dagger(U_e: torch.Tensor, U_o: torch.Tensor,
                        psi_e: torch.Tensor, kappa: float,
                        inner_dtype=None) -> torch.Tensor:
    """A^dagger via gamma5-hermiticity: A^dagger = gamma5 A gamma5.

    With ``inner_dtype``, the result is rounded through it (psi_e is not:
    in the inner CG it is ``schur_matvec``'s rounded output)."""
    if psi_e.device.type != "cpu":
        return schur_op(U_e, U_o, psi_e, kappa, dagger=True,
                        inner_dtype=inner_dtype)
    return schur_composed(U_e, U_o, psi_e, kappa, dagger=True,
                          inner_dtype=inner_dtype)


def eo_rhs(U_e: torch.Tensor, U_o: torch.Tensor, b_e: torch.Tensor,
           b_o: torch.Tensor, kappa: float) -> torch.Tensor:
    """Even-system right-hand side b'_e = b_e + kappa D_eo b_o."""
    return b_e + kappa * dslash_half(U_e, U_o, b_o, src_parity=1)


def reconstruct_odd(U_e: torch.Tensor, U_o: torch.Tensor, x_e: torch.Tensor,
                    b_o: torch.Tensor, kappa: float) -> torch.Tensor:
    """Back-substitute the odd sites: x_o = b_o + kappa D_oe x_e."""
    return b_o + kappa * dslash_half(U_o, U_e, x_e, src_parity=0)
