"""The port's HPL slice on the CPU against the JAX package's, from the
same numpy-built matrices: the blocked LU, the solve (rtol = atol = 2e-2,
``tests/test_hpl.py``'s dense-solve tolerance), the HPL residual, the
Linpack driver and the configuration.

The pivots must be equal.  The packed factors are held at rtol = atol =
5e-4: the two frameworks sum the updates in other orders, and over 192
columns that moves single entries by up to 2.1 times the 1e-4 that
``tests/test_hpl.py`` allows between two JAX runs (measured on 8 seeds at
n = 192); the port's own lookahead variants stay within 1e-4.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import hpl as JH  # noqa: E402
from repro.hpl import blocked_lu as jax_blocked_lu  # noqa: E402
from repro.hpl import linpack_residual as jax_residual  # noqa: E402
from repro.hpl import linpack_run as jax_linpack_run  # noqa: E402
from repro.hpl import lu_solve as jax_lu_solve  # noqa: E402
from repro.hpl.lu import LUResult as JaxLUResult  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import EnergyConfig  # noqa: E402
from repro_torch.configs import hpl as TH  # noqa: E402
from repro_torch.hpl import (blocked_lu, linpack_residual,  # noqa: E402
                             linpack_run, lu_solve)
from repro_torch.hpl import lu as TLU  # noqa: E402
from repro_torch.kernels.dgemm import kernel as K  # noqa: E402
from repro_torch.kernels.panel import kernel as PK  # noqa: E402
from repro_torch.power.trace import TraceRecorder  # noqa: E402

LU_TOL = dict(rtol=5e-4, atol=5e-4)
LOOKAHEAD_TOL = dict(rtol=1e-4, atol=1e-4)
SOLVE_TOL = dict(rtol=2e-2, atol=2e-2)
SIZES = [(128, 16), (128, 32), (192, 16), (192, 32)]


@functools.lru_cache(maxsize=None)
def _system(n, nb):
    rng = np.random.default_rng(n + nb)
    return (rng.standard_normal((n, n)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_lu(n, nb, lookahead):
    r = jax_blocked_lu(jnp.asarray(_system(n, nb)[0]), nb,
                       lookahead=lookahead)
    return np.asarray(r.lu), np.asarray(r.piv)


@pytest.mark.parametrize("lookahead", [0, 1, 2])
@pytest.mark.parametrize("n,nb", SIZES)
def test_blocked_lu_matches_jax(n, nb, lookahead):
    a, _ = _system(n, nb)
    before = dict(K.LAUNCHES)
    got = blocked_lu(convert.matrix_from_numpy(a, "cpu"), nb,
                     lookahead=lookahead)
    assert K.LAUNCHES == before          # the CPU takes the plain update
    lu, piv = _jax_lu(n, nb, lookahead)
    assert got.n_steps == n // nb
    assert got.piv.dtype == torch.int32 and tuple(got.piv.shape) == piv.shape
    np.testing.assert_array_equal(got.piv.numpy(), piv)
    np.testing.assert_allclose(got.lu.numpy(), lu, **LU_TOL)


def _full_row_panel(a, k0, nb, piv):
    """The panel with each swap moving the two full rows at once, the
    order the port's panel had before the swaps of the other columns were
    deferred to after it."""
    one = torch.ones((), dtype=a.dtype)
    rows = torch.arange(a.shape[0])
    for j in range(nb):
        col = k0 + j
        p = torch.argmax(a[col:, col].abs()) + col
        piv[j] = p
        swap = torch.stack((rows[col], p))
        a.index_copy_(0, swap, a.index_select(0, swap.flip(0)))
        pivot = a[col, col]
        a[col + 1:, col].div_(torch.where(pivot.abs() < 1e-30, one, pivot))
        if j + 1 < nb:
            a[col + 1:, col + 1:k0 + nb].addr_(
                a[col + 1:, col], a[col, col + 1:k0 + nb], alpha=-1)


@pytest.mark.parametrize("lookahead", [0, 1, 2])
@pytest.mark.parametrize("n,nb", SIZES)
def test_deferred_swaps_equal_full_row_swaps(n, nb, lookahead, monkeypatch):
    """The panel's swaps within its columns, then the other columns
    swapped after it, give the factors of full-row swaps bit for bit:
    nothing reads the other columns during the panel."""
    t = convert.matrix_from_numpy(_system(n, nb)[0], "cpu")
    got = blocked_lu(t, nb, lookahead=lookahead)
    monkeypatch.setattr(TLU, "_panel_factor", _full_row_panel)
    monkeypatch.setattr(TLU, "_swap_rest", lambda *args: None)
    want = blocked_lu(t, nb, lookahead=lookahead)
    assert torch.equal(got.piv, want.piv)
    assert torch.equal(got.lu, want.lu)


@pytest.mark.parametrize("launch", [PK.panel_lu_, PK.laswp_])
def test_panel_kernels_take_cuda_tensors_only(launch):
    """The CPU takes the plain panel; the kernels' wrappers refuse a CPU
    tensor before they load anything, and launch nothing."""
    before = dict(PK.LAUNCHES)
    a = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="one CUDA device"):
        launch(a, 0, 16, torch.zeros(16, dtype=torch.int32))
    assert PK.LAUNCHES == before


def test_blocked_lu_on_the_cpu_launches_no_panel_kernel():
    before = dict(PK.LAUNCHES)
    blocked_lu(convert.matrix_from_numpy(_system(128, 16)[0], "cpu"), 16)
    assert PK.LAUNCHES == before


def test_blocked_lu_leaves_its_input_alone():
    a, _ = _system(128, 32)
    t = convert.matrix_from_numpy(a, "cpu")
    blocked_lu(t, 32)
    assert np.array_equal(t.numpy(), a)


@pytest.mark.parametrize("lookahead", [1, 2])
def test_lookahead_is_equivalent(lookahead):
    """Lookahead splits the trailing update by columns; the factors are
    the same."""
    t = convert.matrix_from_numpy(_system(192, 32)[0], "cpu")
    r0 = blocked_lu(t, 32, lookahead=0)
    r1 = blocked_lu(t, 32, lookahead=lookahead)
    assert torch.equal(r0.piv, r1.piv)
    torch.testing.assert_close(r0.lu, r1.lu, **LOOKAHEAD_TOL)


@pytest.mark.parametrize("n,nb", SIZES)
def test_lu_solve_matches_jax_and_dense(n, nb):
    a, b = _system(n, nb)
    lu, piv = _jax_lu(n, nb, 1)
    want = np.asarray(jax_lu_solve(
        JaxLUResult(jnp.asarray(lu), jnp.asarray(piv), n // nb),
        jnp.asarray(b), nb))
    dense = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    tb = torch.from_numpy(b)
    # the port's solve on the port's factors
    x = lu_solve(blocked_lu(convert.matrix_from_numpy(a, "cpu"), nb), tb, nb)
    np.testing.assert_allclose(x.numpy(), want, **SOLVE_TOL)
    np.testing.assert_allclose(x.numpy(), dense, **SOLVE_TOL)
    # the port's solve on the JAX package's factors
    x_j = lu_solve(convert.lu_from_numpy(lu, piv, "cpu"), tb, nb)
    np.testing.assert_allclose(x_j.numpy(), want, **SOLVE_TOL)


def test_lu_solve_takes_several_right_hand_sides():
    a, b = _system(128, 16)
    res = blocked_lu(convert.matrix_from_numpy(a, "cpu"), 16)
    bs = torch.from_numpy(np.stack([b, 2 * b], axis=1))
    x = lu_solve(res, bs, 16)
    x1 = lu_solve(res, torch.from_numpy(b), 16)
    torch.testing.assert_close(x[:, 0], x1, **LOOKAHEAD_TOL)
    torch.testing.assert_close(x[:, 1], 2 * x1, **LOOKAHEAD_TOL)


@pytest.mark.parametrize("case", ["solution", "perturbed", "zero"])
def test_linpack_residual_matches_jax(case):
    """At the solution the residual is rounding noise, which the two
    frameworks' products make differently: both must pass.  Away from it
    (x off by 1e-2, or 0) the formula must give the same number."""
    a, b = _system(192, 32)
    x = np.linalg.solve(a.astype(np.float64), b).astype(np.float32)
    if case == "perturbed":
        x += 1e-2 * np.random.default_rng(1).standard_normal(x.shape,
                                                             np.float32)
    elif case == "zero":
        x = np.zeros_like(b)
    got = linpack_residual(*(torch.from_numpy(v) for v in (a, x, b)))
    want = jax_residual(*(jnp.asarray(v) for v in (a, x, b)))
    if case == "solution":
        assert 0 < got < 16.0 and 0 < want < 16.0
    else:
        assert got == pytest.approx(want, rel=1e-4) and got > 16.0


@pytest.mark.parametrize("preset", ["SMOKE_HPL", "efficiency"])
def test_linpack_run_on_the_cpu(preset):
    def cfg(mod):
        return (mod.SMOKE_HPL if preset == "SMOKE_HPL"
                else mod.HPLConfig(n=192, block=64).efficiency())
    got = linpack_run(cfg(TH), device="cpu")
    want = jax_linpack_run(cfg(JH))
    assert got.passed and want.passed
    assert (got.n, got.block, got.mode, got.useful_flops) == (
        want.n, want.block, want.mode, want.useful_flops)
    n, nb = got.n, got.block
    assert got.raw_flops == sum(2.0 * nb * (n - k1) ** 2
                                for k1 in range(nb, n, nb))
    assert got.wall_s > 0 and got.gflops > 0
    assert got.energy_plan is None and got.power_trace is None


@pytest.mark.parametrize("cfg", [
    lambda m: m.SMOKE_HPL, lambda m: m.DEFAULT_HPL,
    lambda m: m.HPLConfig(n=512, block=48, lookahead=2, seed=3),
    lambda m: m.DEFAULT_HPL.efficiency(),
    lambda m: m.HPLConfig(block=40).efficiency(),
])
def test_hpl_config_matches_jax(cfg):
    got, want = cfg(TH), cfg(JH)
    assert vars(got) == vars(want)
    assert vars(got.efficiency()) == vars(want.efficiency())


@pytest.fixture
def fresh_cache():
    """Each package's default autotune cache, empty and in memory."""
    from repro.autotune import TuneCache as JCache
    from repro.autotune import set_default_cache as jset
    from repro_torch.autotune import TuneCache, set_default_cache
    set_default_cache(TuneCache())
    jset(JCache())
    yield
    set_default_cache(None)
    jset(None)


@pytest.mark.parametrize("kwargs", [dict(energy=EnergyConfig()),
                                    dict(recorder=TraceRecorder()),
                                    dict()])
def test_unported_options_raise(fresh_cache, kwargs):
    """``tuned=True`` (which raised before the port had an autotuner)
    runs with each other option: the JAX package's tuned blocking, the
    energy plan and the trace as without it."""
    got = linpack_run(TH.SMOKE_HPL, device="cpu", tuned=True, **kwargs)
    want = jax_linpack_run(JH.SMOKE_HPL, tuned=True)
    assert got.passed and want.passed
    assert (got.block, got.mode) == (want.block, want.mode)
    assert got.block != TH.SMOKE_HPL.block
    assert (got.energy_plan is None) == ("energy" not in kwargs)
    assert (got.power_trace is None) == ("energy" not in kwargs)


def test_tuned_config_raises(fresh_cache):
    """``HPLConfig.tuned`` (which raised before the port had an
    autotuner) equals the JAX package's, field for field."""
    for cfg in (TH.DEFAULT_HPL, TH.HPLConfig(n=4096, mode="efficiency")):
        want = JH.HPLConfig(**vars(cfg)).tuned()
        assert vars(cfg.tuned(device="cpu")) == vars(want)


def test_linpack_run_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linpack_run(TH.SMOKE_HPL)


@pytest.mark.parametrize("bad", [
    lambda: blocked_lu(torch.zeros(96, 64), 32),
    lambda: blocked_lu(torch.zeros(96, 96), 64),
    lambda: linpack_run(TH.HPLConfig(dtype="bfloat16"), device="cpu"),
    lambda: convert.lu_from_numpy(np.zeros((8, 8)), np.zeros((3, 2)), "cpu"),
    lambda: convert.matrix_from_numpy(np.zeros(8), "cpu"),
])
def test_bad_arguments_raise(bad):
    with pytest.raises(ValueError):
        bad()
