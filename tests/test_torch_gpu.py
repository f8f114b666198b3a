"""The port's CUDA kernels and its solve on the card.  Every test here is
marked ``gpu`` and skips without a CUDA device; none imports JAX, so the
file runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import lcsc_lqcd as TL  # noqa: E402
from repro_torch.kernels.dslash import kernel as K  # noqa: E402
from repro_torch.kernels.dslash import ops, ref  # noqa: E402
from repro_torch.lqcd import cg as TC  # noqa: E402
from repro_torch.lqcd import eo as TE  # noqa: E402
from repro_torch.lqcd import su3 as TS  # noqa: E402

pytestmark = pytest.mark.gpu

TOL = dict(rtol=1e-4, atol=1e-4)   # f32 sums run in another order
LATTICES = [(2, 2, 2, 2), (4, 4, 4, 4), (4, 6, 4, 8), (8, 4, 4, 1),
            (16, 8, 8, 8)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fields(shape, device, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    m = (rng.standard_normal((4,) + shape + (3, 3))
         + 1j * rng.standard_normal((4,) + shape + (3, 3)))
    U = TS.su3_project(convert.gauge_from_numpy(m, device))
    psi = convert.spinor_from_numpy(
        rng.standard_normal(shape + (4, 3))
        + 1j * rng.standard_normal(shape + (4, 3)), device)
    return U, psi


@pytest.mark.parametrize("lattice", LATTICES)
def test_full_kernel_matches_plain(cuda, lattice):
    U, psi = _fields(lattice, cuda)
    U_s, psi_s = ref.to_split(U), ref.to_split(psi)
    n = K.LAUNCHES["dslash_split"]
    got = K.dslash_split(U_s, psi_s)
    assert K.LAUNCHES["dslash_split"] == n + 1
    torch.testing.assert_close(got, ref.dslash_split_ref(U_s, psi_s), **TOL)


@pytest.mark.parametrize("src_parity", [0, 1])
@pytest.mark.parametrize("lattice", LATTICES)
def test_eo_kernel_matches_plain(cuda, lattice, src_parity):
    U, psi = _fields(lattice, cuda)
    U_e, U_o = TE.pack_gauge(U)
    U_out, U_src = (U_o, U_e) if src_parity == 0 else (U_e, U_o)
    args = (ref.to_split(U_out), ref.to_split(U_src),
            ref.to_split(TE.eo_pack(psi, src_parity)), src_parity)
    n = K.LAUNCHES["dslash_eo_split"]
    got = K.dslash_eo_split(*args)
    assert K.LAUNCHES["dslash_eo_split"] == n + 1
    torch.testing.assert_close(got, ref.dslash_eo_split_ref(*args), **TOL)


def test_ops_on_the_card_launch_the_kernels(cuda):
    U, psi = _fields((4, 4, 4, 4), cuda)
    before = dict(K.LAUNCHES)
    ops.dslash_op(U, psi)
    U_e, U_o = TE.pack_gauge(U)
    ops.dslash_half_op(U_e, U_o, TE.eo_pack(psi, 0), 0)
    assert K.LAUNCHES["dslash_split"] == before["dslash_split"] + 1
    assert K.LAUNCHES["dslash_eo_split"] == before["dslash_eo_split"] + 1


def test_wrappers_refuse_mixed_devices(cuda):
    U, psi = _fields((4, 4, 4, 4), cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        K.dslash_split(ref.to_split(U).cpu(), ref.to_split(psi))


@pytest.mark.parametrize("preset", ["PLAIN_SOLVER", "EO_SOLVER",
                                    "EO_MIXED_SOLVER"])
def test_solve_on_the_card_matches_the_cpu(cuda, preset):
    cfg = getattr(TL, preset)
    U, b = _fields((8, 8, 8, 8), "cpu", seed=5)
    want = TC.solve_dirac(U, b, 0.12, cfg)
    got = TC.solve_dirac(U.to(cuda), b.to(cuda), 0.12, cfg)
    assert got.converged and want.converged
    assert abs(got.iters - want.iters) <= (2 if cfg.mixed_precision else 1)
    np.testing.assert_allclose(convert.to_numpy(got.x),
                               convert.to_numpy(want.x), rtol=0, atol=2e-4)


def test_random_su3_field_on_the_card(cuda):
    U = TS.random_su3_field(torch.Generator(cuda).manual_seed(0),
                            (8, 8, 8, 8))
    assert U.is_cuda and float(TS.unitarity_defect(U)) < 1e-5
