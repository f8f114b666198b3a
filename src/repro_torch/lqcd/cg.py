"""Conjugate-gradient inversion of the Dirac operator (paper §Introduction:
'inversion of the Dirac operator ... usually performed by a conjugate
gradient algorithm, which involves a sparse matrix-vector-multiplication
called D-slash').

CGNE on the normal equations M†M x = M† b (M is not hermitian), with the
γ5-hermitian adjoint.  The loop runs on the host; the vectors and scalars
stay on the inputs' device.  The stopping test reads the residual norm
back every iteration (one host sync each), which keeps the iteration
counts equal to the JAX package's ``lax.while_loop``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.lqcd.dirac import wilson_matvec, wilson_matvec_dagger
from repro_torch.lqcd.eo import (eo_pack, eo_rhs, eo_unpack, pack_gauge,
                                 reconstruct_odd, schur_matvec,
                                 schur_matvec_dagger)

_INNER_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                 "float64": torch.float64}


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    rel_residual: float
    converged: bool


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Re <a, b> as a 0-dim float32 tensor on the inputs' device."""
    return torch.vdot(a.reshape(-1), b.reshape(-1)).real


def cg_solve(matvec: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
             *, tol: float = 1e-6, max_iters: int = 1000) -> CGResult:
    """CG for hermitian positive-definite ``matvec``."""
    b_norm = torch.sqrt(_dot(b, b))
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = _dot(r, r)
    it = 0
    while it < max_iters and bool(torch.sqrt(rs) > tol * b_norm):
        ap = matvec(p)
        alpha = rs / torch.clamp(_dot(p, ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _dot(r, r)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = r + beta * p
        rs = rs_new
        it += 1
    rel = float(torch.sqrt(rs) / torch.clamp(b_norm, min=1e-30))
    return CGResult(x, it, rel, rel <= tol)


def solve_wilson(U: torch.Tensor, b: torch.Tensor, kappa: float, *,
                 tol: float = 1e-6, max_iters: int = 1000) -> CGResult:
    """Solve M x = b for the Wilson operator via CGNE (M†M x = M† b)."""

    def normal_op(v):
        return wilson_matvec_dagger(U, wilson_matvec(U, v, kappa), kappa)

    rhs = wilson_matvec_dagger(U, b, kappa)
    res = cg_solve(normal_op, rhs, tol=tol, max_iters=max_iters)
    # report the true residual of M x = b
    true_r = b - wilson_matvec(U, res.x, kappa)
    rel = float(torch.sqrt(_dot(true_r, true_r)) / torch.sqrt(_dot(b, b)))
    return CGResult(res.x, res.iters, rel, rel <= tol * 10)


# ---------------------------------------------------------------------------
# Even-odd preconditioned, mixed-precision solver (paper: CL2QCD strategy)
# ---------------------------------------------------------------------------

class EOCGResult(NamedTuple):
    """Result of the even-odd / mixed-precision solve.

    ``iters`` counts normal-op (A†A) applications — directly comparable to
    ``CGResult.iters`` of the unpreconditioned CGNE."""

    x: torch.Tensor
    iters: int                   # inner normal-op applications (total)
    outer_iters: int             # defect-correction (reliable-update) steps
    rel_residual: float          # true ‖b − M x‖ / ‖b‖
    converged: bool


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


def solve_wilson_eo(U: torch.Tensor, b: torch.Tensor, kappa: float, *,
                    tol: float = 1e-6, max_iters: int = 1000,
                    inner_dtype=None, inner_tol: float = 1e-2,
                    max_outer: int = 30, mesh=None) -> EOCGResult:
    """Solve M x = b via the even-odd Schur complement with an (optionally
    mixed-precision) defect-correction CG.

    The Schur system A x_e = b_e + κ D_eo b_o (A = 1 − κ² D_eo D_oe) is
    solved by CGNE on the even half-lattice; odd sites are reconstructed
    exactly as x_o = b_o + κ D_oe x_e.  With ``inner_dtype`` set (e.g.
    ``torch.bfloat16``), the inner CG streams fields rounded through that
    dtype and the outer loop re-computes the residual in f32 and restarts —
    the reliable-update scheme the paper's single/double CG uses.

    With ``mesh`` (a :class:`repro_torch.distributed.LatticeMesh`), the
    Schur operators and the whole inner CG run T-sharded over its shards
    (:class:`repro_torch.lqcd.multichip_eo.ShardedWilsonEO`): the
    hand-written EO kernel on halo-padded blocks on a CUDA mesh, the plain
    hop on a CPU mesh.  The odd sites are then reconstructed on the
    inputs' device from the
    gathered ``x_e`` (the JAX function hands its still-sharded ``x_e`` to
    the one-device reconstruction, which fails there).
    """
    U_e, U_o = pack_gauge(U)
    b_e, b_o = eo_pack(b, 0), eo_pack(b, 1)
    b_norm = float(torch.sqrt(_dot(b, b)))
    # no low-precision pass gets below its own roundoff; full precision
    # drives straight to tol in one outer sweep
    eta = inner_tol if inner_dtype is not None else tol

    if mesh is not None:
        from repro_torch.lqcd.multichip_eo import ShardedWilsonEO
        hi = ShardedWilsonEO(U_e, U_o, kappa, mesh)
        # the inner CG streams the *rounded* gauge field, like the
        # one-device normal_lo path
        lo = hi if inner_dtype is None else ShardedWilsonEO(
            _round_complex(U_e, inner_dtype), _round_complex(U_o, inner_dtype),
            kappa, mesh)
        rhs_e = hi.rhs(b_e, b_o)
        schur, schur_dagger = hi.schur, hi.schur_dagger

        def run_inner(rhs_n, cap):
            return lo.cg_normal(rhs_n, tol=eta, max_iters=cap,
                                inner_dtype=inner_dtype)
    else:
        rhs_e = eo_rhs(U_e, U_o, b_e, b_o, kappa)

        def schur(v):
            return schur_matvec(U_e, U_o, v, kappa)

        def schur_dagger(v):
            return schur_matvec_dagger(U_e, U_o, v, kappa)

        if inner_dtype is not None:
            U_e_lo = _round_complex(U_e, inner_dtype)
            U_o_lo = _round_complex(U_o, inner_dtype)

            def normal_lo(v):
                v = _round_complex(v, inner_dtype)
                av = schur_matvec(U_e_lo, U_o_lo, v, kappa)
                av = _round_complex(av, inner_dtype)
                out = schur_matvec_dagger(U_e_lo, U_o_lo, av, kappa)
                return _round_complex(out, inner_dtype)
        else:
            def normal_lo(v):
                return schur_dagger(schur(v))

        def run_inner(rhs_n, cap):
            return cg_solve(normal_lo, rhs_n, tol=eta, max_iters=cap)

    x_e = torch.zeros_like(rhs_e)
    r_s = rhs_e                              # Schur-system residual
    total_inner = 0
    outer = 0
    while outer < max_outer and total_inner < max_iters:
        rel = float(torch.sqrt(_dot(r_s, r_s))) / max(b_norm, 1e-30)
        if rel <= tol:
            break
        # inner CG on the defect equation A†A e = A† r_s, reduced precision.
        # Cap each low-precision restart so a stalled inner solve (roundoff
        # plateau above inner_tol) can't eat the whole budget in one round.
        remaining = max_iters - total_inner
        round_cap = (remaining if inner_dtype is None
                     else min(remaining, max(10, max_iters // 5)))
        inner = run_inner(schur_dagger(r_s), round_cap)
        total_inner += inner.iters
        x_e = x_e + inner.x
        r_s = rhs_e - schur(x_e)             # recompute in full precision
        outer += 1

    x_o = reconstruct_odd(U_e, U_o, x_e, b_o, kappa)
    x = eo_unpack(x_e, x_o)
    true_r = b - wilson_matvec(U, x, kappa)
    rel = float(torch.sqrt(_dot(true_r, true_r))) / max(b_norm, 1e-30)
    return EOCGResult(x, total_inner, outer, rel, rel <= tol)


def solve_dirac(U: torch.Tensor, b: torch.Tensor, kappa: float, cfg, *,
                mesh=None):
    """Config-driven entry point: dispatch on a
    ``repro_torch.config.SolverConfig``.

    Returns a ``CGResult`` for the plain path and an ``EOCGResult`` for the
    even-odd paths (both expose ``.x``, ``.iters``, ``.rel_residual``,
    ``.converged``).  ``mesh`` routes the even-odd paths through the
    T-sharded solve; the plain path has none and refuses it.
    """
    if cfg.preconditioner == "none":
        if mesh is not None:
            raise ValueError("mesh= requires an even-odd preconditioner "
                             "(cfg.preconditioner != 'none')")
        return solve_wilson(U, b, kappa, tol=cfg.tol,
                            max_iters=cfg.max_iters)
    # float32 inner == working precision: not a mixed-precision solve
    inner = _INNER_DTYPES[cfg.inner_dtype] if cfg.mixed_precision else None
    return solve_wilson_eo(U, b, kappa, tol=cfg.tol,
                           max_iters=cfg.max_iters, inner_dtype=inner,
                           inner_tol=cfg.inner_tol, max_outer=cfg.max_outer,
                           mesh=mesh)
