"""Complex-in/complex-out D-slash on either device: the counterparts of the
JAX package's ``dslash_pallas`` / ``dslash_half_pallas``.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor takes the
hand-written kernel (``kernel.py``), which raises on anything it cannot
run.  There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dslash.kernel import (dslash_eo_split, dslash_split,
                                               schur_eo_split)
from repro_torch.kernels.dslash.ref import (dslash_eo_split_ref,
                                            dslash_split_ref, from_split,
                                            to_split)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def dslash_op(U: torch.Tensor, psi: torch.Tensor) -> torch.Tensor:
    """Full-lattice D-slash of a (X, Y, Z, T, 4, 3) complex field."""
    fn = dslash_split_ref if _on_cpu(U, psi) else dslash_split
    return from_split(fn(to_split(U), to_split(psi)))


def dslash_half_op(U_e: torch.Tensor, U_o: torch.Tensor, psi: torch.Tensor,
                   src_parity: int) -> torch.Tensor:
    """Even-odd hop on complex compact half-fields.

    Same contract as ``repro_torch.lqcd.eo.dslash_half``: ``psi`` lives on
    ``src_parity`` sites (compact layout), the result on the opposite
    parity.  ``U_e``/``U_o`` are the packed gauge halves from
    ``repro_torch.lqcd.eo.pack_gauge``.
    """
    U_out, U_src = (U_o, U_e) if src_parity == 0 else (U_e, U_o)
    fn = dslash_eo_split_ref if _on_cpu(U_e, U_o, psi) else dslash_eo_split
    return from_split(fn(to_split(U_out), to_split(U_src), to_split(psi),
                         src_parity))


def schur_op(U_e: torch.Tensor, U_o: torch.Tensor, psi: torch.Tensor,
             kappa: float, *, dagger: bool = False,
             inner_dtype=None) -> torch.Tensor:
    """The fused even-odd Schur operator on complex compact even
    half-fields on the card (``kernel.schur_eo_split``: two B1 launches).
    CUDA tensors only; on the CPU ``repro_torch.lqcd.eo`` composes it."""
    return from_split(schur_eo_split(to_split(U_e), to_split(U_o),
                                     to_split(psi), kappa, dagger=dagger,
                                     inner_dtype=inner_dtype))
