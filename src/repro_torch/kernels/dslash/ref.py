"""Plain PyTorch versions of the two D-slash kernels, on the re/im-split
layout the kernels take, written from the bodies of the JAX package's
Pallas kernels (``_dslash_kernel`` / ``_dslash_eo_kernel``).

The Pallas kernels block the lattice along T and bring the ±1 T slices in
as halo blocks; a plain version sees the whole lattice, so its T hops are
periodic rolls like the other three directions.

The ops wrappers run these for CPU tensors; on the card they are the
yardstick the kernels are compared with.
"""
from __future__ import annotations

import numpy as np
import torch

# gamma matrices (Dirac basis); order x, y, z, t
_g = np.zeros((4, 4, 4), np.complex64)
_g[0] = [[0, 0, 0, -1j], [0, 0, -1j, 0], [0, 1j, 0, 0], [1j, 0, 0, 0]]
_g[1] = [[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]]
_g[2] = [[0, 0, -1j, 0], [0, 0, 0, 1j], [1j, 0, 0, 0], [0, -1j, 0, 0]]
_g[3] = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -1, 0], [0, 0, 0, -1]]
_eye = np.eye(4, dtype=np.complex64)
PROJ_M = np.stack([_eye - _g[mu] for mu in range(4)])   # (1 - gamma_mu)
PROJ_P = np.stack([_eye + _g[mu] for mu in range(4)])   # (1 + gamma_mu)


def to_split(x: torch.Tensor) -> torch.Tensor:
    """Complex field -> float32 (..., 2) re/im split.  A free view for a
    contiguous complex64 tensor."""
    return torch.view_as_real(
        x.to(torch.complex64).resolve_conj().contiguous())


def from_split(x: torch.Tensor) -> torch.Tensor:
    """float32 (..., 2) re/im split -> complex64.  A free view for a
    contiguous float32 tensor."""
    return torch.view_as_complex(x.to(torch.float32).contiguous())


def _mm(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Σ_b a_ab p_sb: (..., 3, 3) x (..., 4, 3) -> (..., 4, 3)."""
    return (a[..., None, :, :] * p[..., :, None, :]).sum(-1)


def _su3_mv(u: torch.Tensor, psi: torch.Tensor,
            conj_transpose: bool) -> torch.Tensor:
    """(..., 3, 3, 2) x (..., 4, 3, 2) -> (..., 4, 3, 2) complex matvec."""
    u_re, u_im = u[..., 0], u[..., 1]
    p_re, p_im = psi[..., 0], psi[..., 1]
    if conj_transpose:
        # (U†)_{ab} = conj(U_{ba})
        ut_re, ut_im = u_re.transpose(-1, -2), u_im.transpose(-1, -2)
        re = _mm(ut_re, p_re) + _mm(ut_im, p_im)
        im = _mm(ut_re, p_im) - _mm(ut_im, p_re)
    else:
        re = _mm(u_re, p_re) - _mm(u_im, p_im)
        im = _mm(u_re, p_im) + _mm(u_im, p_re)
    return torch.stack([re, im], dim=-1)


def _apply_proj(proj: np.ndarray, hop: torch.Tensor) -> torch.Tensor:
    """Spin projection, unrolled over the projector's nonzero entries
    (only {0, ±1, ±2, ±i} occur)."""
    h_re, h_im = hop[..., 0], hop[..., 1]
    out_re, out_im = [], []
    for s_ in range(4):
        acc_re = torch.zeros_like(h_re[..., 0, :])
        acc_im = torch.zeros_like(acc_re)
        for t_ in range(4):
            cr = float(proj[s_, t_].real)
            ci = float(proj[s_, t_].imag)
            if cr != 0.0:
                acc_re = acc_re + cr * h_re[..., t_, :]
                acc_im = acc_im + cr * h_im[..., t_, :]
            if ci != 0.0:
                acc_re = acc_re - ci * h_im[..., t_, :]
                acc_im = acc_im + ci * h_re[..., t_, :]
        out_re.append(acc_re)
        out_im.append(acc_im)
    return torch.stack([torch.stack(out_re, dim=-2),
                        torch.stack(out_im, dim=-2)], dim=-1)


def dslash_split_ref(U_s: torch.Tensor, psi_s: torch.Tensor) -> torch.Tensor:
    """Full-lattice periodic D-slash on re/im-split fields.

    U_s: (4, X, Y, Z, T, 3, 3, 2) f32; psi_s: (X, Y, Z, T, 4, 3, 2) f32.
    """
    out = torch.zeros_like(psi_s)
    for mu in range(4):
        psi_f = torch.roll(psi_s, -1, mu)
        out = out + _apply_proj(PROJ_M[mu], _su3_mv(U_s[mu], psi_f, False))
        u_b = torch.roll(U_s[mu], 1, mu)
        psi_b = torch.roll(psi_s, 1, mu)
        out = out + _apply_proj(PROJ_P[mu], _su3_mv(u_b, psi_b, True))
    return out


def dslash_eo_split_ref(U_out_s: torch.Tensor, U_src_s: torch.Tensor,
                        psi_s: torch.Tensor, src_parity: int) -> torch.Tensor:
    """Half-lattice D-slash hop on re/im-split compact fields.

    U_out_s/U_src_s: (4, X//2, Y, Z, T, 3, 3, 2) f32 packed at the
    output/source parity; psi_s: (X//2, Y, Z, T, 4, 3, 2) f32 on
    ``src_parity`` sites.  Returns the opposite-parity half-field.
    """
    _, Y, Z, T = psi_s.shape[:4]
    dev = psi_s.device
    # s_out(y, z, t): x offset of the first output-parity site
    iy = torch.arange(Y, device=dev)[:, None, None]
    iz = torch.arange(Z, device=dev)[None, :, None]
    it = torch.arange(T, device=dev)[None, None, :]
    s_out = ((iy + iz + it + 1 - src_parity) % 2 == 1)[..., None, None, None]

    # x hops: output site x = 2i + s_out -> +x neighbour at compact i+s_out,
    # -x neighbour (and its link) at compact i + s_out - 1
    psi_f = torch.where(s_out, torch.roll(psi_s, -1, 0), psi_s)
    psi_b = torch.where(s_out, psi_s, torch.roll(psi_s, 1, 0))
    u_b = torch.where(s_out, U_src_s[0], torch.roll(U_src_s[0], 1, 0))
    out = _apply_proj(PROJ_M[0], _su3_mv(U_out_s[0], psi_f, False))
    out = out + _apply_proj(PROJ_P[0], _su3_mv(u_b, psi_b, True))

    for mu in (1, 2, 3):                    # y, z, t — plain rolls
        psi_f = torch.roll(psi_s, -1, mu)
        psi_b = torch.roll(psi_s, 1, mu)
        u_b = torch.roll(U_src_s[mu], 1, mu)
        out = out + _apply_proj(PROJ_M[mu],
                                _su3_mv(U_out_s[mu], psi_f, False))
        out = out + _apply_proj(PROJ_P[mu], _su3_mv(u_b, psi_b, True))
    return out
