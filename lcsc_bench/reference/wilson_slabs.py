"""The plain reference of the LQCD cells whose field is held as T-slabs,
one slab a card: the Wilson–Dirac operator, its even-odd Schur complement
and a conjugate-gradient solve, in plain PyTorch, written from the
operator's definition as ``wilson.py`` is, so that no slab's card ever
holds the whole field.

    (D ψ)(x) = Σ_μ [ (1 − γ_μ) U_μ(x) ψ(x+μ̂) + (1 + γ_μ) U_μ(x−μ̂)† ψ(x−μ̂) ]
    M = 1 − κ D,  periodic in every direction.

The lattice (X, Y, Z, T) is cut along T into slabs of equal extent, in
order: slab ``j`` holds the global rows ``t = j T_s … (j+1) T_s − 1``,
its ψ (X, Y, Z, T_s, 4, 3) and U (4, X, Y, Z, T_s, 3, 3) on one device
(the γ matrices, directions and layout are ``wilson.py``'s).  D on a slab
reads one row beyond each of its ends: ψ is padded with the neighbours'
boundary rows, copied from their devices, and the −t hop's link
U_t(x − t̂) at the slab's first row is the previous slab's last, copied
once.  x, y and z hops are rolls, the t hops slices of the padded slab.
The even-odd blocks are D between the parity masks (x+y+z+t even or odd,
t global).  Nothing of the program is imported or read.

``dtype`` sets the arithmetic: complex128 for the reference, and a real
``low`` such as ``torch.bfloat16`` rounds the links once and every field
the operator returns through it (the control).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from lcsc_bench.reference.wilson import GAMMA, GAMMA5

T_AX = 3                 # the T axis of a spinor slab


def _round(v: torch.Tensor, low) -> torch.Tensor:
    if low is None:
        return v
    r = torch.view_as_real(v)
    return torch.view_as_complex(r.to(low).to(r.dtype).contiguous())


def colour(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Σ_b u_ab v_sb at every site: u (..., 3, 3), v (..., 4, 3)."""
    return (u[..., None, :, :] * v[..., :, None, :]).sum(-1)


def spin(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Σ_t p_st v_ta at every site: p (4, 4), v (..., 4, 3)."""
    return torch.einsum("st,...ta->...sa", p, v)


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.vdot(a.reshape(-1), b.reshape(-1)).real)


def dot(a: Sequence[torch.Tensor], b: Sequence[torch.Tensor]) -> float:
    """Re <a, b> of two slabbed fields, summed slab by slab."""
    return math.fsum(_dot(x, y) for x, y in zip(a, b))


class SlabWilson:
    """M and its even-odd blocks on one gauge field held as T-slabs
    (``U``: one (4, X, Y, Z, T_s, 3, 3) tensor a slab, each on its own
    device).  Fields are lists of slabs on the same devices."""

    def __init__(self, U: Sequence[torch.Tensor], kappa: float, *,
                 dtype=torch.complex128, low=None):
        self.kappa = float(kappa)
        self.dtype = dtype
        self.low = low
        n = len(U)
        ts = int(U[0].shape[4])
        X, Y, Z = (int(s) for s in U[0].shape[1:4])
        if any(s % 2 for s in (X, Y, Z, ts * n)):
            raise ValueError(f"every extent must be even, got "
                             f"{(X, Y, Z, ts * n)}")
        self.devices = [u.device for u in U]
        # x, y, z links, and the t link padded with the row before the
        # slab: U_t(x − t̂) of its first row is the previous slab's last
        self.U_xyz = [_round(u[:3].to(dtype), low) for u in U]
        self.U_t = [_round(torch.cat(
            [U[(j - 1) % n][3, :, :, :, ts - 1:].to(u.device), u[3]],
            T_AX).to(dtype), low) for j, u in enumerate(U)]
        self.even = []
        for j, d in enumerate(self.devices):
            x, y, z, t = torch.meshgrid(
                *(torch.arange(s, device=d) for s in (X, Y, Z, ts)),
                indexing="ij")
            self.even.append(((x + y + z + t + j * ts) % 2 == 0)[..., None,
                                                                  None])
        g = torch.from_numpy(GAMMA).to(dtype)
        eye = torch.eye(4, dtype=dtype)
        self.proj_m = {d: (eye - g).to(d) for d in set(self.devices)}
        self.proj_p = {d: (eye + g).to(d) for d in set(self.devices)}
        self.g5 = {d: torch.from_numpy(GAMMA5).to(d, dtype)
                   for d in set(self.devices)}

    def _dslash(self, j: int, pad: torch.Tensor) -> torch.Tensor:
        """D on slab ``j`` from its ψ padded with one row on each side."""
        d = pad.device
        pm, pp = self.proj_m[d], self.proj_p[d]
        psi = pad[:, :, :, 1:-1]
        out = torch.zeros_like(psi)
        for mu in range(3):
            u = self.U_xyz[j][mu]
            # forward: (1 − γ_μ) U_μ(x) ψ(x+μ̂)
            out = out + spin(pm[mu], colour(u, torch.roll(psi, -1, mu)))
            # backward: (1 + γ_μ) U_μ(x−μ̂)† ψ(x−μ̂)
            u_b = torch.roll(u, 1, mu).conj().transpose(-1, -2)
            out = out + spin(pp[mu], colour(u_b, torch.roll(psi, 1, mu)))
        u_t = self.U_t[j]
        out = out + spin(pm[3], colour(u_t[:, :, :, 1:], pad[:, :, :, 2:]))
        u_b = u_t[:, :, :, :-1].conj().transpose(-1, -2)
        return out + spin(pp[3], colour(u_b, pad[:, :, :, :-2]))

    def dslash(self, psi: Sequence[torch.Tensor]) -> list:
        """D ψ, slab by slab, each slab's ψ padded with its neighbours'
        boundary rows."""
        n = len(psi)
        out = []
        for j, p in enumerate(psi):
            before = psi[(j - 1) % n][:, :, :, -1:].to(p.device)
            after = psi[(j + 1) % n][:, :, :, :1].to(p.device)
            out.append(self._dslash(j, torch.cat([before, p, after], T_AX)))
        return out

    def field(self, psi: Sequence[torch.Tensor]) -> list:
        """ψ at the operator's precision."""
        return [p.to(self.dtype) for p in psi]

    def hop(self, psi: Sequence[torch.Tensor], out_parity: int) -> list:
        """D restricted to ``out_parity`` sites, of a field ``psi`` on the
        other parity's sites."""
        return [_round(torch.where(e if out_parity == 0 else ~e, d, 0), self.low)
                for e, d in zip(self.even, self.dslash(psi))]

    def gamma5(self, v: Sequence[torch.Tensor]) -> list:
        return [spin(self.g5[x.device], x) for x in v]

    def schur(self, v: Sequence[torch.Tensor]) -> list:
        """A v = v − κ² D_eo D_oe v on the even sites."""
        d = self.hop(self.hop(v, 1), 0)
        return [_round(x - self.kappa ** 2 * y, self.low)
                for x, y in zip(v, d)]

    def schur_dagger(self, v: Sequence[torch.Tensor]) -> list:
        return self.gamma5(self.schur(self.gamma5(v)))

    def matvec(self, psi: Sequence[torch.Tensor]) -> list:
        """M ψ on the whole lattice, slab by slab."""
        return [p - self.kappa * d for p, d in zip(psi, self.dslash(psi))]

    def parity(self, psi: Sequence[torch.Tensor], parity: int) -> list:
        """ψ on the ``parity`` sites, zero on the others."""
        return [torch.where(e if parity == 0 else ~e, p, 0)
                for e, p in zip(self.even, psi)]


def true_residual(op: SlabWilson, x: Sequence[torch.Tensor],
                  b: Sequence[torch.Tensor]) -> float:
    """‖b − M x‖ / ‖b‖ at the operator's precision, each slab's part of
    both norms taken on its own device."""
    bb = op.field(b)
    r = [u - v for u, v in zip(bb, op.matvec(op.field(x)))]
    return math.sqrt(dot(r, r) / dot(bb, bb))


def solve(op: SlabWilson, b: Sequence[torch.Tensor], tol: float,
          max_iters: int) -> tuple[list, int]:
    """Solve M x = b by CGNE on the even sites' Schur system, stopping
    when the Schur residual ‖b' − A x_e‖, which is the whole residual
    once the odd sites are reconstructed, falls to ``tol`` ‖b‖: the
    algorithm of ``wilson.solve``, on slabs.  Returns x (slabs) and the
    normal operators (iterations) it needed."""
    low = op.low

    def axpy(a, x, y):
        return [_round(u + a * v, low) for u, v in zip(x, y)]

    bb = op.field(b)
    b_e, b_o = op.parity(bb, 0), op.parity(bb, 1)
    rhs = axpy(op.kappa, b_e, op.hop(b_o, 0))     # b'
    s = rhs                                 # b' − A x_e, kept recursively
    r = op.schur_dagger(rhs)                # normal residual
    p = r
    x = [torch.zeros_like(v) for v in rhs]
    rr = dot(r, r)
    iters = 0
    stop = tol * math.sqrt(dot(bb, bb))
    while iters < max_iters and math.sqrt(dot(s, s)) > stop:
        q = op.schur(p)
        ap = op.schur_dagger(q)
        alpha = rr / max(dot(p, ap), 1e-30)
        x = axpy(alpha, x, p)
        r = axpy(-alpha, r, ap)
        s = axpy(-alpha, s, q)
        rr_new = dot(r, r)
        p = axpy(rr_new / max(rr, 1e-30), r, p)
        rr = rr_new
        iters += 1
    x_o = axpy(op.kappa, b_o, op.hop(x, 1))
    return [u + v for u, v in zip(x, x_o)], iters
