"""The plain reference of the LQCD cells: the Wilson–Dirac operator, its
even-odd Schur complement and a conjugate-gradient solve, in plain
PyTorch, written from the operator's definition.

    (D ψ)(x) = Σ_μ [ (1 − γ_μ) U_μ(x) ψ(x+μ̂) + (1 + γ_μ) U_μ(x−μ̂)† ψ(x−μ̂) ]
    M = 1 − κ D,  periodic in every direction.

Fields: ψ is (X, Y, Z, T, 4, 3) (spin, colour) and U is
(4, X, Y, Z, T, 3, 3), direction-major in the order x, y, z, t; the γ
matrices are the Dirac basis below, as the configuration states.  The
sites of each parity (x+y+z+t even or odd) are held as a list in
lexicographic order, and every hop gathers its neighbours through index
tables built here.  Nothing of the program is imported or read.

``dtype`` sets the arithmetic: complex128 for the reference, and a real
type such as ``torch.bfloat16`` to round every field through it after
each operation (the control: the reference in the nearest precision
below the configuration's).
"""
from __future__ import annotations

import numpy as np
import torch

_G = {
    "x": [[0, 0, 0, -1j], [0, 0, -1j, 0], [0, 1j, 0, 0], [1j, 0, 0, 0]],
    "y": [[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]],
    "z": [[0, 0, -1j, 0], [0, 0, 0, 1j], [1j, 0, 0, 0], [0, -1j, 0, 0]],
    "t": [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 0], [0, 0, 0, -1]],
}
GAMMA = np.array([_G[k] for k in "xyzt"], dtype=np.complex128)
# γ5 = γ_t γ_x γ_y γ_z in this basis: it swaps the upper and lower spins
GAMMA5 = np.array([[0, 0, 1, 0], [0, 0, 0, 1], [1, 0, 0, 0], [0, 1, 0, 0]],
                  dtype=np.complex128)


def _round(v: torch.Tensor, low) -> torch.Tensor:
    if low is None:
        return v
    r = torch.view_as_real(v)
    return torch.view_as_complex(r.to(low).to(r.dtype).contiguous())


class WilsonEO:
    """The even-odd blocks of M on one gauge field.

    ``low`` (a real torch dtype or None) rounds every field the operator
    returns, and the links once, through that type."""

    def __init__(self, U: torch.Tensor, kappa: float, *,
                 dtype=torch.complex128, low=None):
        self.kappa = float(kappa)
        self.low = low
        lat = tuple(int(s) for s in U.shape[1:5])
        if len(lat) != 4 or any(s % 2 for s in lat):
            raise ValueError(f"every extent must be even, got {lat}")
        self.lat = lat
        dev = U.device
        coords = np.indices(lat).reshape(4, -1)            # lexicographic
        parity = coords.sum(0) % 2
        self.sites = [np.flatnonzero(parity == p) for p in (0, 1)]
        where = np.empty(parity.size, dtype=np.int64)       # slot in its list
        for p in (0, 1):
            where[self.sites[p]] = np.arange(self.sites[p].size)
        flatU = U.reshape(4, -1, 3, 3).to(dtype)
        self.fwd_idx, self.bwd_idx, self.U_fwd, self.U_bwd = {}, {}, {}, {}
        for p in (0, 1):
            own = coords[:, self.sites[p]]
            f_i, b_i, u_f, u_b = [], [], [], []
            for mu in range(4):
                step = np.zeros((4, 1), dtype=np.int64)
                step[mu] = 1
                ext = np.array(lat)[:, None]
                fwd = np.ravel_multi_index(tuple((own + step) % ext), lat)
                bwd = np.ravel_multi_index(tuple((own - step) % ext), lat)
                f_i.append(torch.from_numpy(where[fwd]).to(dev))
                b_i.append(torch.from_numpy(where[bwd]).to(dev))
                here = torch.from_numpy(self.sites[p]).to(dev)
                u_f.append(_round(flatU[mu].index_select(0, here), low))
                there = torch.from_numpy(bwd).to(dev)
                u_b.append(_round(flatU[mu].index_select(0, there)
                                  .conj_physical().transpose(-1, -2), low))
            self.fwd_idx[p], self.bwd_idx[p] = f_i, b_i
            self.U_fwd[p] = torch.stack(u_f)
            self.U_bwd[p] = torch.stack(u_b)
        g = torch.from_numpy(GAMMA).to(dev, dtype)
        eye = torch.eye(4, dtype=dtype, device=dev)
        self.proj_m = eye - g
        self.proj_p = eye + g
        self.g5 = torch.from_numpy(GAMMA5).to(dev, dtype)
        self.dtype = dtype

    # fields of one parity: (V/2, 4, 3)
    def pack(self, psi: torch.Tensor, parity: int) -> torch.Tensor:
        flat = psi.reshape(-1, 4, 3).to(self.dtype)
        idx = torch.from_numpy(self.sites[parity]).to(psi.device)
        return flat.index_select(0, idx)

    def unpack(self, even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
        full = torch.empty((even.shape[0] * 2, 4, 3), dtype=even.dtype,
                           device=even.device)
        for p, half in ((0, even), (1, odd)):
            full[torch.from_numpy(self.sites[p]).to(even.device)] = half
        return full.reshape(self.lat + (4, 3))

    def hop(self, psi: torch.Tensor, out_parity: int) -> torch.Tensor:
        """D restricted to ``out_parity`` sites, of a field ``psi`` on the
        other parity's sites."""
        out = torch.zeros_like(psi)
        p = out_parity
        for mu in range(4):
            for links, idx, proj in (
                    (self.U_fwd[p][mu], self.fwd_idx[p][mu], self.proj_m[mu]),
                    (self.U_bwd[p][mu], self.bwd_idx[p][mu], self.proj_p[mu])):
                nb = psi.index_select(0, idx)                 # (N, 4, 3)
                colour = (links[:, None, :, :] * nb[:, :, None, :]).sum(-1)
                out = out + torch.einsum("st,nta->nsa", proj, colour)
        return _round(out, self.low)

    def gamma5(self, v: torch.Tensor) -> torch.Tensor:
        return torch.einsum("st,nta->nsa", self.g5, v)

    def schur(self, v: torch.Tensor) -> torch.Tensor:
        """A v = v − κ² D_eo D_oe v on the even sites."""
        d = self.hop(self.hop(v, 1), 0)
        return _round(v - self.kappa ** 2 * d, self.low)

    def schur_dagger(self, v: torch.Tensor) -> torch.Tensor:
        return self.gamma5(self.schur(self.gamma5(v)))

    def matvec(self, psi: torch.Tensor) -> torch.Tensor:
        """M ψ on the whole lattice; ``psi`` is (X, Y, Z, T, 4, 3)."""
        e, o = self.pack(psi, 0), self.pack(psi, 1)
        return self.unpack(e - self.kappa * self.hop(o, 0),
                           o - self.kappa * self.hop(e, 1))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.vdot(a.reshape(-1), b.reshape(-1)).real


def true_residual(op: WilsonEO, x: torch.Tensor, b: torch.Tensor) -> float:
    """‖b − M x‖ / ‖b‖ at the operator's precision."""
    bb = b.to(op.dtype)
    r = bb - op.matvec(x.to(op.dtype))
    return float(torch.sqrt(_dot(r, r) / _dot(bb, bb)))


def solve(op: WilsonEO, b: torch.Tensor, tol: float,
          max_iters: int) -> tuple[torch.Tensor, int]:
    """Solve M x = b by CGNE on the even sites' Schur system, stopping
    when the Schur residual ‖b' − A x_e‖, which is the whole residual
    once the odd sites are reconstructed, falls to ``tol`` ‖b‖.  Returns
    x and the normal operators (iterations) it needed."""
    low = op.low
    b_e, b_o = op.pack(b, 0), op.pack(b, 1)
    b_norm = torch.sqrt(_dot(b_e, b_e) + _dot(b_o, b_o))
    rhs = _round(b_e + op.kappa * op.hop(b_o, 0), low)   # b'
    s = rhs                                 # b' − A x_e, kept recursively
    r = op.schur_dagger(rhs)                # normal residual
    p = r
    x = torch.zeros_like(rhs)
    rr = _dot(r, r)
    iters = 0
    stop = tol * float(b_norm)
    while iters < max_iters and float(torch.sqrt(_dot(s, s))) > stop:
        q = op.schur(p)
        ap = op.schur_dagger(q)
        alpha = rr / torch.clamp(_dot(p, ap), min=1e-30)
        x = _round(x + alpha * p, low)
        r = _round(r - alpha * ap, low)
        s = _round(s - alpha * q, low)
        rr_new = _dot(r, r)
        p = _round(r + (rr_new / torch.clamp(rr, min=1e-30)) * p, low)
        rr = rr_new
        iters += 1
    x_o = _round(b_o + op.kappa * op.hop(x, 1), low)
    return op.unpack(x, x_o), iters
