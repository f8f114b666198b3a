"""Carry-over between the JAX package's arrays and the port's tensors.

The JAX package's gauge fields and sources arrive as numpy complex64
(``np.asarray(U)``); these helpers check their layout and place them on a
device, and bring results back.  Layouts are the JAX package's:

  psi: (X, Y, Z, T, 4, 3) complex64   (half-fields: (X/2, Y, Z, T, 4, 3))
  U:   (4, X, Y, Z, T, 3, 3) complex64
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _from_numpy(a, tail: tuple, lead: int, what: str,
                device) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim != lead + 4 + len(tail) or a.shape[lead + 4:] != tail:
        raise ValueError(f"{what} must have shape "
                         f"{('4,' if lead else '')}(X, Y, Z, T){tail}, "
                         f"got {a.shape}")
    # a copy: the caller's array (often a read-only view of a JAX array)
    # never aliases the port's tensor
    a = np.array(a, dtype=np.complex64, order="C")
    return torch.from_numpy(a).to(resolve_device(device))


def gauge_from_numpy(U, device="cuda") -> torch.Tensor:
    """A (4, X, Y, Z, T, 3, 3) gauge field as a complex64 tensor."""
    if np.shape(U)[:1] != (4,):
        raise ValueError(f"gauge field needs 4 directions, got "
                         f"{np.shape(U)}")
    return _from_numpy(U, (3, 3), 1, "gauge field", device)


def spinor_from_numpy(psi, device="cuda") -> torch.Tensor:
    """A (X, Y, Z, T, 4, 3) spinor (or compact half-) field as a complex64
    tensor."""
    return _from_numpy(psi, (4, 3), 0, "spinor field", device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor on any device as a numpy array."""
    return t.detach().cpu().numpy()
