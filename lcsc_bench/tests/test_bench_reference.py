"""The plain references: the Wilson operator against a dense Wilson
matrix built site by site from its definition, the reference solve, and
HPL's residual and blocked LU."""
import numpy as np
import pytest
import torch

from lcsc_bench.lib import inputs
from lcsc_bench.reference import hpl, wilson

LAT = (4, 4, 4, 4)
KAPPA = 0.137


def dense_wilson(U: np.ndarray, kappa: float) -> np.ndarray:
    """M = 1 − κ D as a dense (12 V, 12 V) matrix, one hop at a time."""
    lat = U.shape[1:5]
    V = int(np.prod(lat))
    M = np.eye(12 * V, dtype=np.complex128)
    eye = np.eye(4)
    for site in np.ndindex(*lat):
        i = np.ravel_multi_index(site, lat)
        for mu in range(4):
            fwd = list(site)
            fwd[mu] = (fwd[mu] + 1) % lat[mu]
            bwd = list(site)
            bwd[mu] = (bwd[mu] - 1) % lat[mu]
            j_f = np.ravel_multi_index(fwd, lat)
            j_b = np.ravel_multi_index(bwd, lat)
            hop_f = np.kron(eye - wilson.GAMMA[mu], U[mu][site])
            hop_b = np.kron(eye + wilson.GAMMA[mu],
                            U[mu][tuple(bwd)].conj().T)
            M[12 * i:12 * i + 12, 12 * j_f:12 * j_f + 12] -= kappa * hop_f
            M[12 * i:12 * i + 12, 12 * j_b:12 * j_b + 12] -= kappa * hop_b
    return M


@pytest.fixture(scope="module")
def field():
    U = inputs.su3_field(11, LAT, "cpu")
    b = inputs.spinor(12, LAT, "cpu")
    return U, b


def test_gauge_field_is_su3(field):
    U, _ = field
    u = U.to(torch.complex128)
    eye = torch.eye(3, dtype=u.dtype)
    assert float((u @ u.mH - eye).abs().max()) < 1e-5
    assert float((torch.linalg.det(u) - 1).abs().max()) < 1e-5


def test_gamma_basis():
    g = wilson.GAMMA
    for a in range(4):
        for c in range(4):
            anti = g[a] @ g[c] + g[c] @ g[a]
            assert np.allclose(anti, 2 * np.eye(4) * (a == c))
    assert np.allclose(g[3] @ g[0] @ g[1] @ g[2], wilson.GAMMA5)


def test_operator_against_dense_matrix(field):
    U, b = field
    op = wilson.WilsonEO(U, KAPPA)
    M = dense_wilson(U.numpy().astype(np.complex128), KAPPA)
    want = M @ b.numpy().astype(np.complex128).reshape(-1)
    got = op.matvec(b).numpy().reshape(-1)
    assert np.abs(got - want).max() < 1e-12 * np.abs(want).max()


def test_gamma5_hermiticity(field):
    U, _ = field
    M = dense_wilson(U.numpy().astype(np.complex128), KAPPA)
    g5 = np.kron(np.eye(int(np.prod(LAT))), np.kron(wilson.GAMMA5, np.eye(3)))
    assert np.allclose(M.conj().T, g5 @ M @ g5, atol=1e-12)


def test_schur_solve_meets_tolerance(field):
    U, b = field
    op = wilson.WilsonEO(U, KAPPA)
    x, iters = wilson.solve(op, b, 1e-6, 1000)
    assert 5 < iters < 100
    assert wilson.true_residual(op, x, b) <= 1e-6
    # and against the dense solve
    M = dense_wilson(U.numpy().astype(np.complex128), KAPPA)
    exact = np.linalg.solve(M, b.numpy().astype(np.complex128).reshape(-1))
    err = np.linalg.norm(x.numpy().reshape(-1) - exact) / np.linalg.norm(exact)
    assert err < 1e-5


def test_operator_agrees_with_the_port(field):
    pytest.importorskip("repro_torch")
    from repro_torch.lqcd import wilson_matvec
    U, b = field
    got = wilson.WilsonEO(U, KAPPA).matvec(b)
    port = wilson_matvec(U, b, KAPPA).to(torch.complex128)
    assert float((got - port).abs().max()) < 1e-5 * float(port.abs().max())


def test_hpl_residual_and_lu():
    a, b = inputs.hpl_system(5, 192, "cpu")
    x = hpl.lu_solve(a, b, 32)
    assert hpl.scaled_residual(a, x, b) < 0.1
    exact = torch.linalg.solve(a.double(), b.double())
    assert float((x.double() - exact).abs().max()) < 1e-3 * float(exact.abs().max())
    # one answer wrong by 1 reads far above
    wrong = x.clone()
    wrong[7] += 1.0
    assert hpl.scaled_residual(a, wrong, b) > 100 * hpl.scaled_residual(a, x, b)


def test_round_tf32():
    t = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      1 + 2 ** -12])
    got = hpl.round_tf32(t)
    want = torch.tensor([1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9, 1.0])
    assert torch.equal(got, want)
