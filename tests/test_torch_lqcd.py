"""The PyTorch port's LQCD operator core against the JAX package, module by
module, on the CPU.

Inputs are built once per lattice with numpy from a seed (the gauge field
projected onto SU(3) by the reference) and handed to both packages as the
same arrays, through ``repro_torch.convert``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.lqcd import cg as JC  # noqa: E402
from repro.lqcd import dirac as JD  # noqa: E402
from repro.lqcd import eo as JE  # noqa: E402
from repro.lqcd import su3 as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.lqcd import cg as TC  # noqa: E402
from repro_torch.lqcd import dirac as TD  # noqa: E402
from repro_torch.lqcd import eo as TE  # noqa: E402
from repro_torch.lqcd import su3 as TS  # noqa: E402

SHAPES = [(4, 4, 4, 4), (4, 4, 4, 8), (8, 4, 4, 8)]
TOL = dict(rtol=1e-5, atol=1e-5)
KAPPA = 0.12


@functools.lru_cache(maxsize=None)
def _fields(shape, seed=0):
    """(U, psi) as numpy complex64 and as CPU tensors."""
    rng = np.random.default_rng(seed + sum(shape))
    m = (rng.standard_normal((4,) + shape + (3, 3))
         + 1j * rng.standard_normal((4,) + shape + (3, 3)))
    U = np.asarray(JS.su3_project(jnp.asarray(m.astype(np.complex64))))
    psi = (rng.standard_normal(shape + (4, 3))
           + 1j * rng.standard_normal(shape + (4, 3))).astype(np.complex64)
    return (U, psi, convert.gauge_from_numpy(U, "cpu"),
            convert.spinor_from_numpy(psi, "cpu"))


def _close(got, want, **tol):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               **(tol or TOL))


def test_constants_match():
    np.testing.assert_array_equal(TD.GAMMA.numpy(), np.asarray(JD.GAMMA))
    np.testing.assert_array_equal(TD.GAMMA5.numpy(), np.asarray(JD.GAMMA5))
    np.testing.assert_array_equal(TD.EYE4.numpy(), np.asarray(JD.EYE4))
    assert TD.dslash_flops_per_site() == JD.dslash_flops_per_site()
    for rb in (4, 8):
        for comp in (True, False):
            assert (TD.dslash_bytes_per_site(rb, comp)
                    == JD.dslash_bytes_per_site(rb, comp))


def test_gamma5_permutation_equals_product():
    _, psi, _, tpsi = _fields(SHAPES[0])
    want = np.einsum("st,...ta->...sa", np.asarray(JD.GAMMA5), psi)
    np.testing.assert_array_equal(TD.gamma5(tpsi).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_dslash_matches(shape):
    U, psi, tU, tpsi = _fields(shape)
    _close(TD.dslash(tU, tpsi), JD.dslash(U, psi))


@pytest.mark.parametrize("dagger", [False, True])
def test_wilson_matvec_matches(dagger):
    U, psi, tU, tpsi = _fields(SHAPES[1])
    jf = JD.wilson_matvec_dagger if dagger else JD.wilson_matvec
    tf = TD.wilson_matvec_dagger if dagger else TD.wilson_matvec
    _close(tf(tU, tpsi, KAPPA), jf(U, psi, KAPPA))


def test_parity_mask_and_eo_matvec_match():
    shape = SHAPES[0]
    U, psi, tU, tpsi = _fields(shape)
    mask = TD.parity_mask(shape, device="cpu")
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(JD.parity_mask(shape)))
    jm = JD.parity_mask(shape)
    psi_e = np.where(np.asarray(jm)[..., None, None], psi, 0)
    _close(TD.eo_matvec(tU, convert.spinor_from_numpy(psi_e, "cpu"), KAPPA,
                        mask), JD.eo_matvec(U, psi_e, KAPPA, jm))


def test_dslash_dense_matrix_matches():
    shape = (2, 2, 2, 2)
    U, _, tU, _ = _fields(shape)
    _close(TD.dslash_dense_matrix(tU), JD.dslash_dense_matrix(U))


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_eo_pack_unpack_bit_exact(shape, parity):
    U, psi, tU, tpsi = _fields(shape)
    np.testing.assert_array_equal(TE.eo_pack(tpsi, parity).numpy(),
                                  np.asarray(JE.eo_pack(psi, parity)))
    halves = [TE.eo_pack(tpsi, p) for p in (0, 1)]
    np.testing.assert_array_equal(TE.eo_unpack(*halves).numpy(), psi)
    tUe, tUo = TE.pack_gauge(tU)
    jUe, jUo = JE.pack_gauge(U)
    np.testing.assert_array_equal((tUe, tUo)[parity].numpy(),
                                  np.asarray((jUe, jUo)[parity]))


def test_eo_pack_rejects_odd_x():
    with pytest.raises(ValueError, match="even x extent"):
        TE.eo_pack(torch.zeros((3, 2, 2, 2, 4, 3), dtype=torch.complex64), 0)


@pytest.mark.parametrize("src_parity", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_dslash_half_matches(shape, src_parity):
    U, psi, tU, tpsi = _fields(shape)
    jUe, jUo = JE.pack_gauge(U)
    tUe, tUo = TE.pack_gauge(tU)
    jo, js = (jUo, jUe) if src_parity == 0 else (jUe, jUo)
    to, ts = (tUo, tUe) if src_parity == 0 else (tUe, tUo)
    want = JE.dslash_half(jo, js, JE.eo_pack(psi, src_parity), src_parity)
    _close(TE.dslash_half(to, ts, TE.eo_pack(tpsi, src_parity), src_parity),
           want)


@pytest.mark.parametrize("dagger", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_schur_matches(shape, dagger):
    U, psi, tU, tpsi = _fields(shape)
    jf = JE.schur_matvec_dagger if dagger else JE.schur_matvec
    tf = TE.schur_matvec_dagger if dagger else TE.schur_matvec
    want = jf(*JE.pack_gauge(U), JE.eo_pack(psi, 0), KAPPA)
    _close(tf(*TE.pack_gauge(tU), TE.eo_pack(tpsi, 0), KAPPA), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_eo_rhs_and_reconstruct_match(shape):
    U, psi, tU, tpsi = _fields(shape)
    jU, tUh = JE.pack_gauge(U), TE.pack_gauge(tU)
    je, jo = JE.eo_pack(psi, 0), JE.eo_pack(psi, 1)
    te, to = TE.eo_pack(tpsi, 0), TE.eo_pack(tpsi, 1)
    _close(TE.eo_rhs(*tUh, te, to, KAPPA), JE.eo_rhs(*jU, je, jo, KAPPA))
    _close(TE.reconstruct_odd(*tUh, te, to, KAPPA),
           JE.reconstruct_odd(*jU, je, jo, KAPPA))


def test_su3_project_matches():
    rng = np.random.default_rng(7)
    m = (rng.standard_normal((64, 3, 3))
         + 1j * rng.standard_normal((64, 3, 3))).astype(np.complex64)
    got = TS.su3_project(torch.from_numpy(m))
    _close(got, JS.su3_project(jnp.asarray(m)))
    # a matrix already in SU(3) is a fixed point
    _close(TS.su3_project(got), got.numpy())


def test_random_su3_field_is_su3():
    # enough matrices that ill-conditioned draws occur (one Gram-Schmidt
    # pass would leave a defect above 1e-5 on them)
    U = TS.random_su3_field(torch.Generator().manual_seed(3), (8, 8, 8, 8),
                            device="cpu")
    assert U.shape == (4, 8, 8, 8, 8, 3, 3) and U.dtype == torch.complex64
    assert float(TS.unitarity_defect(U)) < 1e-5
    det = TS._det3(U)
    assert float((det - 1).abs().max()) < 1e-5
    again = TS.random_su3_field(torch.Generator().manual_seed(3),
                                (8, 8, 8, 8), device="cpu")
    np.testing.assert_array_equal(again.numpy(), U.numpy())


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, an entry point that creates tensors raises unless
    the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.random_su3_field(torch.Generator(), (2, 2, 2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.spinor_from_numpy(np.zeros((2, 2, 2, 2, 4, 3)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.parity_mask((2, 2, 2, 2))


def test_convert_round_trip_and_shape_checks():
    U, psi, tU, tpsi = _fields(SHAPES[0])
    np.testing.assert_array_equal(convert.to_numpy(tU), U)
    np.testing.assert_array_equal(convert.to_numpy(tpsi), psi)
    with pytest.raises(ValueError):
        convert.spinor_from_numpy(np.zeros((2, 2, 2, 2, 3, 4)), "cpu")
    with pytest.raises(ValueError):
        convert.gauge_from_numpy(np.zeros((3, 2, 2, 2, 2, 3, 3)), "cpu")


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_round_complex_bit_equal(dtype):
    rng = np.random.default_rng(11)
    v = (rng.standard_normal((4, 4, 4, 4, 4, 3))
         + 1j * rng.standard_normal((4, 4, 4, 4, 4, 3))).astype(np.complex64)
    want = np.asarray(JC._round_complex(jnp.asarray(v), jnp.dtype(dtype)))
    got = TC._round_complex(torch.from_numpy(v), getattr(torch, dtype))
    np.testing.assert_array_equal(got.numpy().view(np.float32),
                                  want.view(np.float32))


def test_round_complex_noops():
    v = torch.randn(8, 3, dtype=torch.complex64)
    assert TC._round_complex(v, None) is v
    np.testing.assert_array_equal(TC._round_complex(v, torch.float64).numpy(),
                                  v.numpy())
