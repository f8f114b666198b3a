"""The benchmark's inputs, made on the device from a seed in a few
large calls: a hot-start SU(3) gauge field, Gaussian spinor sources, and
HPL's standard normal A and b.  The same seed gives the same inputs on
the same device."""
from __future__ import annotations

import torch


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def su3_field(seed: int, lattice, device) -> torch.Tensor:
    """A hot-start gauge field (4, X, Y, Z, T, 3, 3) complex64: each link
    is a complex Gaussian 3 x 3 matrix made special unitary (its first two
    columns orthonormalised, the third their conjugated cross product)."""
    shape = (4,) + tuple(lattice) + (3, 3, 2)
    m = torch.view_as_complex(torch.randn(shape, generator=_gen(seed, device),
                                          device=device))
    u = m[..., 0]
    u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
    v = m[..., 1]
    v = v - (u.conj() * v).sum(-1, keepdim=True) * u
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    w = torch.linalg.cross(u, v).conj()
    return torch.stack((u, v, w), dim=-1).contiguous()


def spinor(seed: int, lattice, device) -> torch.Tensor:
    """A Gaussian source (X, Y, Z, T, 4, 3) complex64, unit variance in
    each real component."""
    shape = tuple(lattice) + (4, 3, 2)
    return torch.view_as_complex(torch.randn(
        shape, generator=_gen(seed, device), device=device))


def hpl_system(seed: int, n: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """HPL's A (n, n) and b (n,), float32, standard normal."""
    gen = _gen(seed, device)
    a = torch.randn((n, n), generator=gen, device=device)
    b = torch.randn((n,), generator=gen, device=device)
    return a, b
