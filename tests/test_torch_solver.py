"""The whole single-device slice: the port's solvers against the JAX
package's (``mesh=None``) on the CPU, from the same numpy-built inputs.

Iteration counts may differ by one normal op (two with a bf16 inner
solve), because the two frameworks sum the CG's dot products in other
orders; solutions agree to 2e-4.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import lcsc_lqcd as JL  # noqa: E402
from repro.lqcd import cg as JC  # noqa: E402
from repro.lqcd import su3 as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import lcsc_lqcd as TL  # noqa: E402
from repro_torch.lqcd import cg as TC  # noqa: E402

KAPPA = 0.12
PRESETS = ["PLAIN_SOLVER", "EO_SOLVER", "EO_MIXED_SOLVER"]


@functools.lru_cache(maxsize=None)
def _fields(shape):
    rng = np.random.default_rng(200 + sum(shape))
    m = (rng.standard_normal((4,) + shape + (3, 3))
         + 1j * rng.standard_normal((4,) + shape + (3, 3)))
    U = np.asarray(JS.su3_project(jnp.asarray(m.astype(np.complex64))))
    b = (rng.standard_normal(shape + (4, 3))
         + 1j * rng.standard_normal(shape + (4, 3))).astype(np.complex64)
    return (U, b, convert.gauge_from_numpy(U, "cpu"),
            convert.spinor_from_numpy(b, "cpu"))


def _agree(jr, tr, slack, tol):
    assert abs(int(jr.iters) - tr.iters) <= slack
    if hasattr(jr, "outer_iters"):
        assert abs(jr.outer_iters - tr.outer_iters) <= 1
    np.testing.assert_allclose(convert.to_numpy(tr.x), np.asarray(jr.x),
                               rtol=0, atol=2e-4)
    assert tr.rel_residual <= tol
    assert tr.converged == bool(jr.converged)


@pytest.mark.parametrize("shape", [(4, 4, 4, 4), (8, 8, 8, 8)])
@pytest.mark.parametrize("preset", PRESETS)
def test_solve_dirac_matches_jax(preset, shape):
    U, b, tU, tb = _fields(shape)
    jr = JC.solve_dirac(U, b, KAPPA, getattr(JL, preset))
    tr = TC.solve_dirac(tU, tb, KAPPA, getattr(TL, preset))
    assert tr.converged
    # plain CGNE stops on the normal-equation residual and calls a true
    # residual within 10 x tol converged (as the JAX package does)
    tol = 1e-5 if preset == "PLAIN_SOLVER" else 1e-6
    _agree(jr, tr, 2 if preset == "EO_MIXED_SOLVER" else 1, tol)


def test_solve_wilson_matches_jax():
    U, b, tU, tb = _fields((4, 4, 4, 8))
    jr = JC.solve_wilson(U, b, KAPPA, tol=1e-6, max_iters=200)
    tr = TC.solve_wilson(tU, tb, KAPPA, tol=1e-6, max_iters=200)
    _agree(jr, tr, 1, 1e-5)


@pytest.mark.parametrize("inner", [None, "bfloat16"])
def test_solve_wilson_eo_matches_jax(inner):
    U, b, tU, tb = _fields((4, 4, 4, 8))
    jr = JC.solve_wilson_eo(U, b, KAPPA, inner_dtype=inner and jnp.bfloat16)
    tr = TC.solve_wilson_eo(tU, tb, KAPPA,
                            inner_dtype=inner and torch.bfloat16)
    assert tr.converged
    _agree(jr, tr, 2 if inner else 1, 1e-6)


def test_cg_solve_respects_max_iters():
    _, b, tU, tb = _fields((4, 4, 4, 4))
    res = TC.solve_wilson(tU, tb, KAPPA, tol=1e-12, max_iters=3)
    assert res.iters == 3 and not res.converged


def test_mesh_is_not_ported_yet():
    _, _, tU, tb = _fields((4, 4, 4, 4))
    with pytest.raises(NotImplementedError):
        TC.solve_dirac(tU, tb, KAPPA, TL.EO_SOLVER, mesh=object())
    with pytest.raises(NotImplementedError):
        TC.solve_wilson_eo(tU, tb, KAPPA, mesh=object())


def test_configs_match_jax():
    for name in PRESETS:
        t, j = getattr(TL, name), getattr(JL, name)
        assert (t.preconditioner, t.inner_dtype, t.tol, t.max_iters,
                t.inner_tol, t.max_outer, t.mixed_precision) == (
            j.preconditioner, j.inner_dtype, j.tol, j.max_iters,
            j.inner_tol, j.max_outer, j.mixed_precision)
    for name in ("THERMAL_LATTICE", "COLD_LATTICE", "SMOKE_LATTICE"):
        t, j = getattr(TL, name), getattr(JL, name)
        assert (t.shape, t.kappa, t.volume, t.mem_gb) == (
            j.shape, j.kappa, j.volume, j.mem_gb)
    with pytest.raises(ValueError):
        TL.SolverConfig(inner_dtype="int8")
