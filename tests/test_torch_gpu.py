"""The port's CUDA kernels, its solve and its LU on the card.  Every test here is
marked ``gpu`` and skips without a CUDA device; none imports JAX, so the
file runs on a machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import lcsc_lqcd as TL  # noqa: E402
from repro_torch.hpl import blocked_lu, lu_solve  # noqa: E402
from repro_torch.kernels.dgemm import kernel as G  # noqa: E402
from repro_torch.kernels.dgemm import ops as gops  # noqa: E402
from repro_torch.kernels.dgemm import ref as gref  # noqa: E402
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
    torch.backends.cudnn.allow_tf32 = False
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


# the GEMM kernel: tests/test_kernels.py::test_dgemm_sweep's tolerances
GEMM_TOL = {torch.float32: dict(rtol=2e-5, atol=1e-3),
            torch.bfloat16: dict(rtol=0.1, atol=0.1)}
GEMM_SHAPES = [(128, 128, 128), (256, 128, 384), (512, 256, 128),
               (1, 1, 1), (130, 67, 259), (257, 129, 3), (5, 300, 0),
               (1000, 36, 256)]


def _gemm_operands(m, n, k, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed + m + n + k)
    return (torch.randn(m, k, generator=g).to(device, dtype),
            torch.randn(k, n, generator=g).to(device, dtype))


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_gemm_kernel_matches_plain(cuda, m, n, k, dtype, out_dtype):
    x, y = _gemm_operands(m, n, k, dtype, cuda)
    before = G.LAUNCHES["dgemm"]
    got = G.dgemm(x, y, out_dtype)
    assert G.LAUNCHES["dgemm"] == before + 1
    want = gref.dgemm_ref(x, y, out_dtype)
    assert got.dtype == want.dtype
    torch.testing.assert_close(got, want, **GEMM_TOL[want.dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES)
def test_gemm_update_kernel_matches_plain(cuda, m, n, k, dtype):
    x, y = _gemm_operands(m, n, k, dtype, cuda, seed=1)
    c = torch.randn(m, n, device=cuda).to(dtype)
    want = gref.dgemm_update_ref_(c.clone(), x, y)
    assert G.dgemm_update_(c, x, y) is c
    torch.testing.assert_close(c, want, **GEMM_TOL[dtype])


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("k0", [256, 257, 258, 259])
def test_gemm_update_kernel_on_views(cuda, k0, lookahead):
    """HPL's trailing update on views of one matrix, with the window's
    start 16-byte aligned (k0 = 256) and not (the others)."""
    n, nb = 1024, 128
    a = torch.randn(n, n, generator=torch.Generator().manual_seed(k0)).to(cuda)
    got, want = a.clone(), a.clone()
    k1 = k0 + nb
    for t, fn in ((got, G.dgemm_update_), (want, gref.dgemm_update_ref_)):
        l21, u12, a22 = t[k1:, k0:k1], t[k0:k1, k1:], t[k1:, k1:]
        if lookahead:
            fn(a22[:, :nb], l21, u12[:, :nb])
            fn(a22[:, nb:], l21, u12[:, nb:])
        else:
            fn(a22, l21, u12)
    torch.testing.assert_close(got, want, **GEMM_TOL[torch.float32])
    assert torch.equal(got[:k1], a[:k1]) and torch.equal(got[:, :k1], a[:, :k1])


def test_ops_dgemm_on_the_card_launches_the_kernel(cuda):
    x, y = _gemm_operands(256, 128, 384, torch.float32, cuda)
    before = G.LAUNCHES["dgemm"]
    got = gops.dgemm(x, y, bm=128, bn=128, bk=128)
    c = torch.zeros(256, 128, device=cuda)
    gops.dgemm_update_(c, x, y)
    assert G.LAUNCHES["dgemm"] == before + 2
    torch.testing.assert_close(got, -c, rtol=0, atol=0)


def test_gemm_kernel_refuses_mixed_devices(cuda):
    x, y = _gemm_operands(64, 64, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        G.dgemm(x, y.cpu())


@pytest.mark.parametrize("lookahead", [0, 1])
def test_blocked_lu_on_the_card_matches_the_cpu(cuda, lookahead):
    n, nb = 192, 32
    # seed 9: its closest pivot choice is a 0.4% gap, far above rounding
    rng = np.random.default_rng(9)
    a = convert.matrix_from_numpy(rng.standard_normal((n, n)), "cpu")
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    want = blocked_lu(a, nb, lookahead=lookahead)
    before = G.LAUNCHES["dgemm"]
    got = blocked_lu(a.to(cuda), nb, lookahead=lookahead)
    steps = n // nb
    expect = 2 * (steps - 1) - 1 if lookahead else steps - 1
    assert G.LAUNCHES["dgemm"] == before + expect
    assert torch.equal(got.piv.cpu(), want.piv)
    # f32 sums in another order (tests/test_torch_hpl.py's tolerance)
    torch.testing.assert_close(got.lu.cpu(), want.lu, rtol=5e-4, atol=5e-4)
    x = lu_solve(got, b.to(cuda), nb)
    torch.testing.assert_close(x.cpu(), lu_solve(want, b, nb), rtol=2e-2,
                               atol=2e-2)
