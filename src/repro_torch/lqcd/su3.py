"""SU(3) gauge-field helpers."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.device import resolve_device


def _det3(q: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices, by cofactors."""
    a = [[q[..., i, j] for j in range(3)] for i in range(3)]
    return (a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
            - a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
            + a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]))


def su3_project(m: torch.Tensor) -> torch.Tensor:
    """Project arbitrary 3x3 matrices back onto SU(3) (reunitarization).

    The QR factor with a real-positive R diagonal (the JAX package takes a
    Householder QR and fixes the phases afterwards; Gram–Schmidt on the
    columns gives that same unique Q directly, in a few batched
    elementwise ops on any device), divided by the cube root of its
    determinant.  Each column is orthogonalised twice: one pass loses
    orthogonality in proportion to the matrix's condition number, which
    random Gaussian matrices push past f32 roundoff.
    """
    cols = []
    for j in range(3):
        v = m[..., :, j]
        for _ in range(2):
            for q in cols:
                v = v - (q.conj() * v).sum(-1, keepdim=True) * q
        cols.append(v / torch.linalg.vector_norm(v, dim=-1, keepdim=True))
    q = torch.stack(cols, dim=-1)
    return q * (_det3(q).conj() ** (1.0 / 3.0))[..., None, None]


def random_su3(gen: torch.Generator, shape: Tuple[int, ...],
               device="cuda") -> torch.Tensor:
    """Random SU(3) matrices of shape (*shape, 3, 3) complex64: the SU(3)
    projection of a random complex Gaussian matrix.  ``gen`` is a
    ``torch.Generator`` on ``device``."""
    dev = resolve_device(device)
    re = torch.randn(tuple(shape) + (3, 3), generator=gen, device=dev)
    im = torch.randn(tuple(shape) + (3, 3), generator=gen, device=dev)
    return su3_project(torch.complex(re, im))


def random_su3_field(gen: torch.Generator,
                     lattice_shape: Tuple[int, int, int, int],
                     device="cuda") -> torch.Tensor:
    """Gauge field U_mu(x): shape (4, X, Y, Z, T, 3, 3).  ``gen`` is a
    ``torch.Generator`` on ``device``."""
    return random_su3(gen, (4,) + tuple(lattice_shape), device)


def random_field_and_source(lattice_shape: Tuple[int, int, int, int],
                            seed: int, device="cuda"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A random gauge field (4, X, Y, Z, T, 3, 3) and a complex Gaussian
    source (X, Y, Z, T, 4, 3), both complex64, drawn in that order from a
    ``torch.Generator`` on ``device`` seeded with ``seed``: the fields the
    LQCD workload solves and the calibration times."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in lattice_shape)
    gen = torch.Generator(dev).manual_seed(seed)
    U = random_su3_field(gen, shape, dev)
    b = torch.complex(torch.randn(shape + (4, 3), generator=gen, device=dev),
                      torch.randn(shape + (4, 3), generator=gen, device=dev))
    return U, b


def unitarity_defect(u: torch.Tensor) -> torch.Tensor:
    """max |U U† − 1| — 0 for exact SU(3)."""
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    uu = torch.einsum("...ab,...cb->...ac", u, u.conj())
    return (uu - eye).abs().max()
