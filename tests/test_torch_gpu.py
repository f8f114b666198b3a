"""The port's CUDA kernels, its solve, its LU, its serve path (mamba2
and a smoke model of every other family), its train step, training
driver and checkpoints on the card.  Every test here is marked ``gpu`` and skips without a CUDA
device; none imports JAX, so the file runs on a machine that has only
PyTorch:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import lcsc_lqcd as TL  # noqa: E402
from repro_torch.hpl import blocked_lu, lu_solve  # noqa: E402
from repro_torch.hpl import lu as TLU  # noqa: E402
from repro_torch.kernels.dgemm import kernel as G  # noqa: E402
from repro_torch.kernels.dgemm import ops as gops  # noqa: E402
from repro_torch.kernels.dgemm import ref as gref  # noqa: E402
from repro_torch.kernels.dslash import kernel as K  # noqa: E402
from repro_torch.kernels.panel import kernel as PK  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as RMK  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rmops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rmref  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as SSK  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops as ssops  # noqa: E402
from repro_torch.kernels.ssd_chunk import ref as ssref  # noqa: E402
from repro_torch.kernels.dslash import ops, ref  # noqa: E402
from repro_torch.distributed import (gather_t_blocks, lattice_mesh,  # noqa: E402
                                     split_t_blocks)
from repro_torch.lqcd import cg as TC  # noqa: E402
from repro_torch.lqcd import dirac as TD  # noqa: E402
from repro_torch.lqcd import eo as TE  # noqa: E402
from repro_torch.lqcd import multichip as TM  # noqa: E402
from repro_torch.lqcd import multichip_eo as TMC  # noqa: E402
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


# -- the fused Schur operator: B1 with a load transform and an epilogue ---

INNER = [None, torch.bfloat16, torch.float16, torch.float64, torch.float32,
         torch.complex64]


@pytest.mark.parametrize("dagger", [False, True])
@pytest.mark.parametrize("inner", INNER, ids=str)
@pytest.mark.parametrize("lattice", [(32, 32, 32, 8), (8, 6, 4, 6)],
                         ids=str)
def test_fused_schur_equals_the_plain_kernel_composition(cuda, lattice,
                                                        inner, dagger):
    """Two fused B1 launches against two plain ones and the torch passes
    (rounding, gamma5, the axpy) they replace, bit for bit."""
    U, psi = _fields(lattice, cuda)
    U_e, U_o = (TC._round_complex(h, inner) for h in TE.pack_gauge(U))
    v = TE.eo_pack(psi, 0) * 3.0
    before = dict(K.LAUNCHES)
    want = TE.schur_composed(U_e, U_o, v, 0.23, dagger=dagger,
                             inner_dtype=inner)
    assert K.LAUNCHES["dslash_eo_split"] == before["dslash_eo_split"] + 2
    assert K.LAUNCHES["dslash_eo_fused"] == before["dslash_eo_fused"]
    fn = TE.schur_matvec_dagger if dagger else TE.schur_matvec
    got = fn(U_e, U_o, v, 0.23, inner)
    assert K.LAUNCHES["dslash_eo_split"] == before["dslash_eo_split"] + 4
    assert K.LAUNCHES["dslash_eo_fused"] == before["dslash_eo_fused"] + 2
    assert torch.equal(got, want)


def test_fused_solve_equals_the_unfused_solve(cuda, monkeypatch):
    """EO_MIXED at 32^3 x 8: the solve through the fused Schur operator
    and the solve through the plain hops and torch passes it replaced
    take the same iterations to the same answer."""
    U, b = _fields((32, 32, 32, 8), cuda, seed=3)
    before = dict(K.LAUNCHES)
    got = TC.solve_dirac(U, b, 0.137, TL.EO_MIXED_SOLVER)
    fused = K.LAUNCHES["dslash_eo_fused"] - before["dslash_eo_fused"]
    hops = K.LAUNCHES["dslash_eo_split"] - before["dslash_eo_split"]
    assert got.converged and got.rel_residual <= 1e-6
    assert fused == 4 * got.iters + 4 * got.outer_iters
    assert hops == 4 * got.iters + 4 * got.outer_iters + 2

    def composed(dagger):
        def fn(U_e, U_o, v, kappa, inner_dtype=None):
            return TE.schur_composed(U_e, U_o, v, kappa, dagger=dagger,
                                     inner_dtype=inner_dtype)
        return fn

    monkeypatch.setattr(TC, "schur_matvec", composed(False))
    monkeypatch.setattr(TC, "schur_matvec_dagger", composed(True))
    before = dict(K.LAUNCHES)
    want = TC.solve_dirac(U, b, 0.137, TL.EO_MIXED_SOLVER)
    assert K.LAUNCHES["dslash_eo_fused"] == before["dslash_eo_fused"]
    assert (want.iters, want.outer_iters) == (got.iters, got.outer_iters)
    assert torch.equal(got.x, want.x)
    assert got.rel_residual == want.rel_residual


# -- the T-sharded path: several shards on the card -----------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("lattice", [(8, 8, 8, 16), (16, 8, 8, 8)])
def test_sharded_eo_hop_equals_the_one_device_kernel(cuda, lattice, n):
    """Every real row of a padded block reads the one-device operands in
    the same order: the cropped hops equal B1's one-device hop bit for
    bit, one B1 launch per shard."""
    U, psi = _fields(lattice, cuda)
    U_e, U_o = TE.pack_gauge(U)
    mesh = lattice_mesh(lattice[3], n, devices=("cuda:0",))
    assert mesh.n == n and mesh.distinct_devices == (torch.device("cuda", 0),)
    ops_ = TMC.ShardedWilsonEO(U_e, U_o, 0.1, mesh)
    assert ops_.backend == "kernel"
    for src_parity in (0, 1):
        p = TE.eo_pack(psi, src_parity)
        U_out, U_src = (U_o, U_e) if src_parity == 0 else (U_e, U_o)
        want = TE.dslash_half(U_out, U_src, p, src_parity)
        before = K.LAUNCHES["dslash_eo_split"]
        got = ops_.dslash_half(p, src_parity)
        assert K.LAUNCHES["dslash_eo_split"] == before + n
        assert torch.equal(got, want)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_full_hop_equals_the_one_device_kernel(cuda, n):
    U, psi = _fields((8, 8, 8, 16), cuda)
    mesh = lattice_mesh(16, n)
    want = TD.dslash(U, psi)
    before = K.LAUNCHES["dslash_split"]
    c = TM.dslash_sharded(U, psi, mesh, compress=True)
    u = TM.dslash_sharded(U, psi, mesh, compress=False)
    assert K.LAUNCHES["dslash_split"] == before + 2 * n
    assert torch.equal(c, u) and torch.equal(c, want)


def test_no_plain_hop_runs_on_the_card(cuda):
    U, _ = _fields((4, 4, 4, 8), cuda)
    U_e, U_o = TE.pack_gauge(U)
    assert TMC.ShardedWilsonEO(U_e, U_o, 0.1,
                               lattice_mesh(8, 2)).backend == "kernel"
    with pytest.raises(ValueError, match="unknown backend"):
        TMC.ShardedWilsonEO(U_e, U_o, 0.1, lattice_mesh(8, 2),
                            backend="plain")
    # the padded kernel path needs an even local T extent
    with pytest.raises(ValueError, match="even local T"):
        TMC.ShardedWilsonEO(U_e, U_o, 0.1, lattice_mesh(8, 8))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_solve_on_the_card_matches_one_device(cuda, n):
    """EO_MIXED at 16^3 x 16: the sharded solve (B1 on padded blocks)
    against the one-device solve (B1 on the whole lattice)."""
    U, b = _fields((16, 16, 16, 16), cuda, seed=3)
    want = TC.solve_dirac(U, b, 0.137, TL.EO_MIXED_SOLVER)
    before = K.LAUNCHES["dslash_eo_split"]
    got = TC.solve_dirac(U, b, 0.137, TL.EO_MIXED_SOLVER,
                         mesh=lattice_mesh(16, n))
    launches = K.LAUNCHES["dslash_eo_split"] - before
    assert got.converged and got.rel_residual <= 1e-6
    assert abs(got.iters - want.iters) <= 2
    assert abs(got.outer_iters - want.outer_iters) <= 1
    # per outer step one Schur dagger and one Schur op (4 sharded hops),
    # 4 per inner normal op; the rhs and the odd reconstruction, sharded
    assert launches == n * (4 * got.iters + 4 * got.outer_iters + 2)
    scale = float(want.x.abs().max())
    assert float((got.x - want.x).abs().max()) <= 1e-3 * scale


def test_shards_on_several_cards(cuda):
    """Never run on a one-card machine: the shards spread over every
    visible card, halos copied between them."""
    k = torch.cuda.device_count()
    if k < 2:
        pytest.skip("needs two or more CUDA devices")
    U, b = _fields((8, 8, 8, 16), cuda, seed=3)
    mesh = lattice_mesh(16, min(k, 8))       # T_local 8, 4 or 2: even
    assert len(mesh.distinct_devices) >= 2
    U_e, U_o = TE.pack_gauge(U)
    p = TE.eo_pack(b, 0)
    got = TMC.ShardedWilsonEO(U_e, U_o, 0.1, mesh).dslash_half(p, 0)
    assert torch.equal(got, TE.dslash_half(U_o, U_e, p, 0))
    res = TC.solve_dirac(U, b, 0.137, TL.EO_MIXED_SOLVER, mesh=mesh)
    assert res.converged and res.rel_residual <= 1e-6
    # the same field as T-slabs on their cards: the slab entry point's x
    # is the whole-tensor solve's, cut into the same slabs, bit for bit
    slabs = [split_t_blocks(v, mesh, ax) for v, ax in ((U, 4), (b, 3))]
    got = TC.solve_dirac(*slabs, 0.137, TL.EO_MIXED_SOLVER, mesh=mesh)
    assert (got.iters, got.outer_iters) == (res.iters, res.outer_iters)
    assert [x.device for x in got.x] == list(mesh.devices)
    assert torch.equal(gather_t_blocks(got.x, 3, b.device), res.x)


def test_a_sharded_hop_leaves_the_current_device(cuda):
    """B1's and B2's launchers put the caller's current device back: hops
    over cards 0-3 leave ``torch.cuda.current_device()`` as it was."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices")
    U, b = _fields((8, 8, 8, 16), cuda, seed=3)
    mesh = lattice_mesh(16, 4)
    assert len(mesh.distinct_devices) == 4
    U_e, U_o = TE.pack_gauge(U)
    p = TE.eo_pack(b, 0)
    try:
        for current in (0, 2):
            torch.cuda.set_device(current)
            TMC.ShardedWilsonEO(U_e, U_o, 0.1, mesh).dslash_half(p, 0)
            TM.dslash_sharded(U, b, mesh)
            assert torch.cuda.current_device() == current
    finally:
        torch.cuda.set_device(0)


def test_random_su3_field_on_the_card(cuda):
    U = TS.random_su3_field(torch.Generator(cuda).manual_seed(0),
                            (8, 8, 8, 8))
    assert U.is_cuda and float(TS.unitarity_defect(U)) < 1e-5


# the GEMM kernel: tests/test_kernels.py::test_dgemm_sweep's tolerances
GEMM_TOL = {torch.float32: dict(rtol=2e-5, atol=1e-3),
            torch.bfloat16: dict(rtol=0.1, atol=0.1)}
GEMM_SHAPES = [(128, 128, 128), (256, 128, 384), (512, 256, 128),
               (1, 1, 1), (130, 67, 259), (257, 129, 3), (5, 300, 0),
               (1000, 36, 256), (64, 64, 1), (200, 96, 7), (300, 260, 17)]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off", [0, 1, 2, 3])
def test_gemm_kernel_on_views_of_any_alignment(cuda, off, dtype):
    """x and y as views whose first element and row stride are 16-byte
    aligned (off = 0: the 16-byte copies) or only element aligned; a
    ragged last 16-byte chunk of y's rows (width 38)."""
    g = torch.Generator().manual_seed(off)
    big = torch.randn(300, 300, generator=g).to(cuda, dtype)
    x = big[off:off + 70, off:off + 19]
    y = big[off + 100:off + 119, off:off + 38]
    got = G.dgemm(x, y, torch.float32)
    torch.testing.assert_close(got, gref.dgemm_ref(x, y, torch.float32),
                               **GEMM_TOL[dtype])


def test_gemm_launches_on_the_253_launch_path(cuda):
    """linpack_run at n = 2048, nb = 16, lookahead 1 has HPL's n = 32768,
    nb = 256 step count (128 panels): 127 next-panel and 126 rest updates."""
    from repro_torch.configs.hpl import HPLConfig
    from repro_torch.hpl import linpack_run
    before = G.LAUNCHES["dgemm"]
    res = linpack_run(HPLConfig(n=2048, block=16, lookahead=1))
    assert G.LAUNCHES["dgemm"] == before + 253
    assert res.passed and res.residual < 16


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
    panels = dict(PK.LAUNCHES)
    got = blocked_lu(a.to(cuda), nb, lookahead=lookahead)
    steps = n // nb
    expect = 2 * (steps - 1) - 1 if lookahead else steps - 1
    assert G.LAUNCHES["dgemm"] == before + expect
    # one panel kernel and one swap kernel a panel
    assert (PK.LAUNCHES["panel_lu"] - panels["panel_lu"]
            == PK.LAUNCHES["laswp"] - panels["laswp"] == steps)
    assert torch.equal(got.piv.cpu(), want.piv)
    # f32 sums in another order (tests/test_torch_hpl.py's tolerance)
    torch.testing.assert_close(got.lu.cpu(), want.lu, rtol=5e-4, atol=5e-4)
    x = lu_solve(got, b.to(cuda), nb)
    torch.testing.assert_close(x.cpu(), lu_solve(want, b, nb), rtol=2e-2,
                               atol=2e-2)


# HPL's panel kernel against the plain panel on the card: the same pivots,
# the factors at tests/test_torch_hpl.py's tolerance (both round the
# rank-1 update once an element, as an FMA, but need not agree on it).
# Over 2048 columns the rounding grows past it for any two versions: the
# plain panel on the CPU and on the card differ by 7.6e-3 there (max|lu|
# 103), so that panel is held normwise, at 2e-4 of max|lu|.  Each panel is
# also held to a float64 LU with the same pivots: no farther from it than
# twice the plain panel (the kernel 6.1e-3, the plain 5.7e-3 at 2048).
LU_TOL = dict(rtol=5e-4, atol=5e-4)
WIDE_PANEL_NORMWISE = 2e-4


def _plain_panel(a, nb):
    piv = torch.empty(nb, dtype=torch.int32, device=a.device)
    TLU._panel_factor(a, 0, nb, piv)
    return piv


def _kernel_panel(a, nb):
    piv = torch.empty(nb, dtype=torch.int32, device=a.device)
    before = PK.LAUNCHES["panel_lu"]
    PK.panel_lu_(a, 0, nb, piv)
    assert PK.LAUNCHES["panel_lu"] == before + 1
    return piv


def _f64_panel(a, piv, nb):
    """The panel's LU in float64 with the given pivots."""
    a = a[:, :nb].double().clone()
    for j, p in enumerate(piv.tolist()):
        a[[j, p]] = a[[p, j]]
        a[j + 1:, j] /= a[j, j]
        a[j + 1:, j + 1:] -= torch.outer(a[j + 1:, j], a[j, j + 1:])
    return a


@pytest.mark.parametrize("m,nb", [(192, 32), (1000, 16), (4096, 256),
                                  (4096, 2048)])
def test_panel_kernel_matches_plain(cuda, m, nb):
    """A panel of m rows and nb columns with two columns more on its right,
    which the kernel must not touch."""
    rng = np.random.default_rng(m + nb)
    a = torch.from_numpy(rng.standard_normal((m, nb + 2))
                         .astype(np.float32)).to(cuda)
    want = a.clone()
    want_piv = _plain_panel(want, nb)
    got = a.clone()
    got_piv = _kernel_panel(got, nb)
    torch.cuda.synchronize()
    assert torch.equal(got_piv.cpu(), want_piv.cpu())
    if nb <= 256:
        torch.testing.assert_close(got[:, :nb].cpu(), want[:, :nb].cpu(),
                                   **LU_TOL)
    else:
        scale = want[:, :nb].abs().max()
        assert (got - want)[:, :nb].abs().max() <= WIDE_PANEL_NORMWISE * scale
    exact = _f64_panel(a, want_piv, nb)
    err = (got[:, :nb].double() - exact).abs().max()
    assert err <= 2 * (want[:, :nb].double() - exact).abs().max()
    assert torch.equal(got[:, nb:], a[:, nb:])


def test_panel_kernel_on_a_view(cuda):
    """The panel at row and column k0 of a larger matrix: rows above it
    and columns beside it stay as they are; the pivots are rows of the
    matrix."""
    rng = np.random.default_rng(3)
    n, k0, nb = 640, 128, 64
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)
                         ).to(cuda)
    want = a.clone()
    want_piv = torch.empty(nb, dtype=torch.int32, device=cuda)
    TLU._panel_factor(want, k0, nb, want_piv)
    got = a.clone()
    got_piv = torch.empty(nb, dtype=torch.int32, device=cuda)
    PK.panel_lu_(got, k0, nb, got_piv)
    torch.cuda.synchronize()
    assert torch.equal(got_piv, want_piv)
    assert int(got_piv.min()) >= k0
    torch.testing.assert_close(got[:, k0:k0 + nb].cpu(),
                               want[:, k0:k0 + nb].cpu(), **LU_TOL)
    outside = torch.ones(n, n, dtype=torch.bool, device=cuda)
    outside[k0:, k0:k0 + nb] = False
    assert torch.equal(got[outside], a[outside])


def test_panel_kernel_takes_the_first_of_equal_maxima(cuda):
    """Equal |a| in a column, of either sign, on rows that different
    blocks of the grid hold: the lowest row wins, as torch.argmax's."""
    rng = np.random.default_rng(5)
    m, nb = 4096, 64
    a = rng.standard_normal((m, nb)).astype(np.float32)
    a[:, 0] = np.clip(a[:, 0], -2, 2)
    a[[3001, 77, 2050, 999], 0] = [9, -9, 9, -9]
    t = torch.from_numpy(a).to(cuda)
    want = t.clone()
    want_piv = _plain_panel(want, nb)
    got = t.clone()
    got_piv = _kernel_panel(got, nb)
    assert got_piv[0].item() == 77
    assert torch.equal(got_piv, want_piv)
    torch.testing.assert_close(got.cpu(), want.cpu(), **LU_TOL)


def test_panel_kernel_on_a_zero_column(cuda):
    """A zero column divides by 1 (the 1e-30 guard): no inf or NaN, and
    the plain panel's factors."""
    rng = np.random.default_rng(6)
    m, nb = 1000, 48
    a = rng.standard_normal((m, nb)).astype(np.float32)
    a[:, 5] = 0
    a[:, 40] = 1e-31 * a[:, 40]
    t = torch.from_numpy(a).to(cuda)
    want = t.clone()
    want_piv = _plain_panel(want, nb)
    got = t.clone()
    got_piv = _kernel_panel(got, nb)
    assert torch.isfinite(got).all()
    assert got_piv[5].item() == 5
    assert torch.equal(got_piv, want_piv)
    torch.testing.assert_close(got.cpu(), want.cpu(), **LU_TOL)


@pytest.mark.parametrize("n,k0,nb", [(192, 64, 32), (1000, 200, 40),
                                     (4096, 0, 2048), (4096, 2048, 2048),
                                     (2048, 768, 256)])
def test_laswp_kernel_equals_plain_swaps(cuda, n, k0, nb):
    """The swaps of a factored panel, on the columns outside it, bit for
    bit as the plain row swaps; the panel's columns stay."""
    rng = np.random.default_rng(n + k0)
    a = torch.from_numpy(rng.standard_normal((n, n)).astype(np.float32)
                         ).to(cuda)
    piv = torch.empty(nb, dtype=torch.int32, device=cuda)
    PK.panel_lu_(a, k0, nb, piv)
    want = a.clone()
    TLU._swap_rest(want, k0, nb, piv)
    got = a.clone()
    before = PK.LAUNCHES["laswp"]
    PK.laswp_(got, k0, nb, piv)
    assert PK.LAUNCHES["laswp"] == before + 1
    assert torch.equal(got, want)
    assert not torch.equal(got, a)


def test_panel_kernels_refuse_what_they_cannot_run(cuda):
    a = torch.zeros(64, 64, device=cuda)
    piv = torch.empty(16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        PK.panel_lu_(a, 0, 16, piv.cpu())
    with pytest.raises(ValueError, match="one CUDA device"):
        PK.laswp_(a.cpu(), 0, 16, piv.cpu())
    with pytest.raises(TypeError):
        PK.panel_lu_(a.double(), 0, 16, piv)
    with pytest.raises(ValueError, match="no 16-column panel"):
        PK.panel_lu_(a, 56, 16, piv)
    with pytest.raises(ValueError, match="row-major"):
        PK.laswp_(a.t(), 0, 16, piv)


# the GEMM's two tiles: the 64-row tile gives the 128-row tile's bits (both
# sum each output over k in one order) on ragged shapes, views and both
# dtypes, product and update
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,k", GEMM_SHAPES + [(1024, 1024, 256),
                                                (65, 129, 33)])
def test_gemm_tiles_agree_bit_for_bit(cuda, m, n, k, dtype):
    x, y = _gemm_operands(m, n, k, dtype, cuda, seed=2)
    before = dict(G.LAUNCHES)
    big = G.dgemm(x, y)
    small = G.dgemm(x, y, bm=64)
    launched = 1 if m and n else 0
    assert G.LAUNCHES["dgemm_64x128"] == before["dgemm_64x128"] + launched
    assert G.LAUNCHES["dgemm_128x128"] == before["dgemm_128x128"] + launched
    assert G.LAUNCHES["dgemm"] == before["dgemm"] + 2 * launched
    assert torch.equal(small, big)
    torch.testing.assert_close(small, gref.dgemm_ref(x, y), **GEMM_TOL[dtype])
    c = torch.randn(m, n, generator=torch.Generator().manual_seed(m)).to(
        cuda, dtype)
    c64 = c.clone()
    G.dgemm_update_(c, x, y)
    G.dgemm_update_(c64, x, y, bm=64)
    assert torch.equal(c64, c)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("off", [0, 3])
def test_gemm_tiles_agree_on_views(cuda, off, dtype):
    """HPL's update on views of one matrix (aligned and not) with either
    tile, and a product of unaligned views."""
    n, nb = 1024, 128
    g = torch.Generator().manual_seed(off)
    a = torch.randn(n, n, generator=g).to(cuda, dtype)
    got = {}
    for bm in (128, 64):
        t = a.clone()
        k0 = 256 + off
        k1 = k0 + nb
        G.dgemm_update_(t[k1:, k1:], t[k1:, k0:k1], t[k0:k1, k1:], bm=bm)
        got[bm] = t
        x, y = a[off:off + 70, off:off + 19], a[off + 100:off + 119, :38]
        got[(bm, "product")] = G.dgemm(x, y, torch.float32, bm=bm)
    assert torch.equal(got[64], got[128])
    assert torch.equal(got[(64, "product")], got[(128, "product")])
    want = a.clone()
    k0 = 256 + off
    k1 = k0 + nb
    gref.dgemm_update_ref_(want[k1:, k1:], want[k1:, k0:k1],
                           want[k0:k1, k1:])
    torch.testing.assert_close(got[64], want, **GEMM_TOL[dtype])


def test_gemm_tile_refusal(cuda):
    x, y = _gemm_operands(64, 64, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="tiles of"):
        G.dgemm(x, y, bm=96)


@pytest.mark.parametrize("bm, rows", [(64, 64), (32, 64), (None, 128),
                                      (128, 128), (256, 128)])
def test_ops_dgemm_launches_the_tile_bm_resolves_to(cuda, bm, rows):
    x, y = _gemm_operands(256, 128, 384, torch.float32, cuda)
    before = dict(G.LAUNCHES)
    got = gops.dgemm(x, y, bm=bm, bn=128, bk=128)
    for r in G.TILE_ROWS:
        key = f"dgemm_{r}x128"
        assert G.LAUNCHES[key] == before[key] + (r == rows)
    torch.testing.assert_close(got, gref.dgemm_ref(x, y),
                               **GEMM_TOL[torch.float32])


def test_tuned_dgemm_on_the_card_keys_by_the_card(cuda):
    from repro_torch.autotune import TuneCache, set_default_cache, tuned_config
    cache = TuneCache()
    set_default_cache(cache)
    try:
        x, y = _gemm_operands(1024, 1024, 256, torch.float32, cuda)
        before = dict(G.LAUNCHES)
        got = gops.dgemm(x, y, tuned=True)
        name = torch.cuda.get_device_name(cuda)
        entry = cache.get("dgemm", (1024, 256, 1024), name)
        assert entry is not None and entry.config["bm"] == 64
        assert G.LAUNCHES["dgemm_64x128"] == before["dgemm_64x128"] + 1
        torch.testing.assert_close(got, gref.dgemm_ref(x, y),
                                   **GEMM_TOL[torch.float32])
        assert tuned_config("hpl", (1024,)) == tuned_config(
            "hpl", (1024,), device=cuda)
        assert cache.keys() == tuple(sorted(
            [f"dgemm|1024x256x1024|{name}", f"hpl|1024|{name}"]))
    finally:
        set_default_cache(None)


def test_measured_dgemm_model_on_the_card(cuda):
    from repro_torch.autotune import MeasuredDgemmModel, tune_dgemm_tiles
    model = MeasuredDgemmModel(1024, 256, 1024, reps=5)
    before = dict(G.LAUNCHES)
    for bm in (128, 64):
        perf, power = model.evaluate({"bm": bm, "bn": 128, "bk": 16})
        assert perf > 0 and power > 0
    assert G.LAUNCHES["dgemm_64x128"] > before["dgemm_64x128"]
    assert G.LAUNCHES["dgemm_128x128"] > before["dgemm_128x128"]
    assert tune_dgemm_tiles(1024, 256, 1024, measured=True).evaluations == 2


def test_tuned_hpl_on_the_card(cuda):
    from repro_torch.autotune import TuneCache, set_default_cache
    from repro_torch.configs.hpl import HPLConfig
    from repro_torch.hpl import linpack_run
    set_default_cache(TuneCache())
    try:
        cfg = HPLConfig(n=1024).tuned()
        before = G.LAUNCHES["dgemm_128x128"]
        res = linpack_run(cfg)
        again = linpack_run(HPLConfig(n=1024, mode="efficiency"), tuned=True)
    finally:
        set_default_cache(None)
    assert (cfg.block, cfg.lookahead) == (256, 1)
    assert res.passed and res.block == 256 and res.gflops > 0
    assert again.passed and again.mode == "efficiency"
    assert G.LAUNCHES["dgemm_128x128"] > before


# the RMSNorm kernel: tests/test_kernels.py::test_rmsnorm_sweep's
# tolerances, ragged row counts, float32 and bfloat16 (x and w each)
RMS_TOL = {torch.float32: 1e-5, torch.bfloat16: 0.05}


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(64, 128), (256, 512), (132, 256),
                                    (1, 1024), (7, 2048), (1000, 33)])
def test_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype, w_dtype):
    g = torch.Generator().manual_seed(rows + d)
    x = torch.randn(rows, d, generator=g).to(cuda, dtype)
    w = torch.randn(d, generator=g).to(cuda, w_dtype)
    before = RMK.LAUNCHES["rmsnorm"]
    got = RMK.rmsnorm(x, w)
    assert RMK.LAUNCHES["rmsnorm"] == before + 1
    want = rmref.rmsnorm_ref(x, w)
    assert got.dtype == dtype
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_rmsnorm_kernel_on_a_row_view(cuda):
    x = torch.randn(33, 512, generator=torch.Generator().manual_seed(1))
    x = x.to(cuda)[:, 3:259]                 # row stride 512, off 16 bytes
    w = torch.randn(256, device=cuda)
    torch.testing.assert_close(RMK.rmsnorm(x, w), rmref.rmsnorm_ref(x, w),
                               rtol=1e-5, atol=1e-5)


def test_ops_rmsnorm_on_the_card_launches_the_kernel(cuda):
    x = torch.randn(2, 3, 64, device=cuda).bfloat16()
    w = torch.randn(64, device=cuda).bfloat16()
    before = RMK.LAUNCHES["rmsnorm"]
    got = rmops.rmsnorm(x, w)
    assert RMK.LAUNCHES["rmsnorm"] == before + 1 and got.shape == x.shape


def test_rmsnorm_kernel_refuses_mixed_devices(cuda):
    with pytest.raises(ValueError, match="one CUDA device"):
        RMK.rmsnorm(torch.ones(4, 8, device=cuda), torch.ones(8))


def _vec(dtype):
    return 16 // torch.empty((), dtype=dtype).element_size()


# (rows, d, x dtype, the kernel the library picks): each register
# variant's largest d (G warps x 32 lanes x 4 vectors), one vector below
# and one above; the generic kernel past G = 8 and off the vector grid
RMS_VARIANT_CASES = [
    (rows, g * 128 * _vec(dt) + dv * _vec(dt), dt,
     f"rows_g{g}" if dv <= 0 else
     (f"rows_g{2 * g}" if g < 8 else "block"))
    for dt in (torch.float32, torch.bfloat16)
    for g in (1, 2, 4, 8)
    for dv, rows in ((-1, 37), (0, 8), (1, 37))
] + [(1000, 33, torch.float32, "block"), (5, 1028, torch.bfloat16, "block")]


def _rms_case(rows, d, dtype, w_dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed + rows + d)
    x = torch.randn(rows, d, generator=g).to(device, dtype)
    return x, torch.randn(d, generator=g).to(device, w_dtype)


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d,dtype,variant", RMS_VARIANT_CASES)
def test_rmsnorm_each_variant_matches_plain(cuda, rows, d, dtype, variant,
                                            w_dtype):
    x, w = _rms_case(rows, d, dtype, w_dtype, cuda)
    assert RMK.variant(x, w)[0] == variant
    before = RMK.variant_launches()
    got = RMK.rmsnorm(x, w)
    after = RMK.variant_launches()
    assert after[variant] == before[variant] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(got.float(), rmref.rmsnorm_ref(x, w).float(),
                               rtol=tol, atol=tol)


def test_rmsnorm_counts_its_launches_by_shape(cuda):
    RMK.reset_launches()
    for rows, d, dtype in ((4, 1024, torch.bfloat16), (4, 1024,
                           torch.bfloat16), (4, 2048, torch.float32),
                           (0, 1024, torch.bfloat16)):
        RMK.rmsnorm(*_rms_case(rows, d, dtype, torch.bfloat16, cuda))
    assert RMK.SHAPE_LAUNCHES == {(4, 1024, torch.bfloat16): 2,
                                  (4, 2048, torch.float32): 1}
    assert RMK.LAUNCHES["rmsnorm"] == 3


def test_rmsnorm_variant_cases_cover_every_kernel(cuda):
    seen = set()
    for rows, d, dtype, _ in RMS_VARIANT_CASES:
        x, w = _rms_case(rows, d, dtype, dtype, cuda)
        seen.add(RMK.variant(x, w)[0])
    assert seen == set(RMK.VARIANTS)


def test_rmsnorm_variant_refuses_unaligned_operands(cuda):
    x, w = _rms_case(8, 1040, torch.bfloat16, torch.bfloat16, cuda)
    assert RMK.variant(x, w) == ("rows_g2", 2)
    assert RMK.variant(x[:, 8:1032], w[:1024]) == ("rows_g1", 4)
    assert RMK.variant(x[:, 1:1025], w[:1024])[0] == "block"   # x off 16 B
    assert RMK.variant(x[:, :1024], w[1:1025])[0] == "block"   # w off 16 B
    assert RMK.variant(x[:, :1020], w[:1020])[0] == "block"    # d off vector


# rows = 1, rows that leave a block's slots empty, and more rows than the
# persistent grid holds (the grid-stride loop), at each path width
@pytest.mark.parametrize("rows", [1, 3, 9, 8193, 20000])
@pytest.mark.parametrize("d,dtype,w_dtype", [
    (1024, torch.bfloat16, torch.bfloat16),
    (2048, torch.float32, torch.bfloat16)])
def test_rmsnorm_kernel_row_counts(cuda, rows, d, dtype, w_dtype):
    x, w = _rms_case(rows, d, dtype, w_dtype, cuda)
    got = RMK.rmsnorm(x, w)
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(got.float(), rmref.rmsnorm_ref(x, w).float(),
                               rtol=tol, atol=tol)


# the serve path's four shapes (mamba2-370m, batch 4, prompt 2048): norm1
# and final_norm in bf16, the gated norm in f32 with a bf16 scale, in
# prefill and in one decode step; two calls give the same bits
@pytest.mark.parametrize("rows,d,dtype,variant", [
    (8192, 1024, torch.bfloat16, "rows_g1"),
    (8192, 2048, torch.float32, "rows_g4"),
    (4, 1024, torch.bfloat16, "rows_g1"),
    (4, 2048, torch.float32, "rows_g4")])
def test_rmsnorm_kernel_at_the_path_shapes(cuda, rows, d, dtype, variant):
    x, w = _rms_case(rows, d, dtype, torch.bfloat16, cuda)
    assert RMK.variant(x, w)[0] == variant
    got = RMK.rmsnorm(x, w)
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(got.float(), rmref.rmsnorm_ref(x, w).float(),
                               rtol=tol, atol=tol)
    assert torch.equal(RMK.rmsnorm(x, w), got)


# the attention families' serve shapes: llama3-8b (batch 4, prompt 2048:
# prefill and decode), hymba-1.5b (1 x 3072: norm1 and its f32 gated norm
# over d_inner 3200), deepseek-v2-236b (4 x 512: d_model, q_norm over
# 1536, kv_norm over 512 on a view whose rows are 576 wide)
@pytest.mark.parametrize("rows,d,dtype,w_dtype,row_stride", [
    (8192, 4096, torch.bfloat16, torch.bfloat16, 4096),
    (4, 4096, torch.bfloat16, torch.bfloat16, 4096),
    (3072, 1600, torch.bfloat16, torch.bfloat16, 1600),
    (1, 1600, torch.bfloat16, torch.bfloat16, 1600),
    (3072, 3200, torch.float32, torch.bfloat16, 3200),
    (1, 3200, torch.float32, torch.bfloat16, 3200),
    (2048, 5120, torch.bfloat16, torch.bfloat16, 5120),
    (2048, 1536, torch.bfloat16, torch.bfloat16, 1536),
    (2048, 512, torch.bfloat16, torch.bfloat16, 576),
    (4, 512, torch.bfloat16, torch.bfloat16, 576)])
def test_rmsnorm_kernel_at_the_attention_path_shapes(cuda, rows, d, dtype,
                                                     w_dtype, row_stride):
    x, w = _rms_case(rows, row_stride, dtype, w_dtype, cuda)
    x, w = x[:, :d], w[:d].contiguous()
    got = RMK.rmsnorm(x, w)
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(got.float(), rmref.rmsnorm_ref(x, w).float(),
                               rtol=tol, atol=tol)
    assert torch.equal(RMK.rmsnorm(x, w), got)


# the SSD-chunk kernel: test_ssd_chunk_sweep's shapes at its 1e-4, the
# smoke model's chunk, ragged chunks and P, N off the tiles; x, B, C in
# float32 and bfloat16
SSD_SHAPES = [(2, 16, 3, 8, 4), (1, 32, 2, 16, 8), (3, 8, 4, 4, 16),
              (2, 32, 8, 16, 16), (1, 45, 2, 20, 33), (2, 70, 2, 64, 128),
              (1, 1, 1, 1, 1), (1, 300, 1, 128, 7), (2, 33, 3, 128, 256),
              (1, 44, 5, 64, 128), (3, 1, 3, 64, 128)]


def _ssd_inputs(B, Q, H, P, N, dtype, device, strided=False):
    g = torch.Generator().manual_seed(B + Q + H + P + N)
    x = torch.randn(B, Q, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, Q, H, generator=g))
    A = -torch.exp(torch.randn(H, generator=g) * 0.3)
    bm = torch.randn(B, Q, N, generator=g)
    cm = torch.randn(B, Q, N, generator=g)
    h = torch.randn(B, H, P, N, generator=g)
    x, dt, A, bm, cm, h = (t.to(device) for t in (x, dt, A, bm, cm, h))
    x, bm, cm = x.to(dtype), bm.to(dtype), cm.to(dtype)
    if strided:      # views of one conv output, as the model passes them
        big = torch.cat([x.reshape(B, Q, H * P), bm, cm], -1)
        x = big[..., :H * P].reshape(B, Q, H, P)
        bm, cm = big[..., H * P:H * P + N], big[..., H * P + N:]
        dt = torch.cat([dt, dt], -1)[..., :H]
    return x, dt, A, bm, cm, h


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Q,H,P,N", SSD_SHAPES)
def test_ssd_chunk_kernel_matches_plain(cuda, B, Q, H, P, N, dtype,
                                        strided):
    args = _ssd_inputs(B, Q, H, P, N, dtype, cuda, strided)
    before = SSK.LAUNCHES["ssd_chunk"]
    y, hn = SSK.ssd_chunk(*args)
    assert SSK.LAUNCHES["ssd_chunk"] == before + 1
    yr, hr = ssref.ssd_chunk_ref(*args)
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(hn, hr, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Q,H,P,N", [(4, 256, 32, 64, 128),
                                       (1, 256, 3, 128, 256),
                                       (2, 256, 5, 20, 33)])
def test_ssd_chunk_kernel_on_a_full_chunk(cuda, B, Q, H, P, N, dtype,
                                          strided):
    """A whole chunk of the serve path (Q = 256), with H not a multiple
    of the head group and the widest P and N: at Q = 256 the f32 sums are
    themselves off an f64 evaluation by up to ~1e-5 of max|y|, so the
    absolute tolerance scales with max|y| (chip_smoke.py's path check)."""
    args = _ssd_inputs(B, Q, H, P, N, dtype, cuda, strided)
    for got, want in zip(SSK.ssd_chunk(*args), ssref.ssd_chunk_ref(*args)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_kernel_at_hymbas_chunk(cuda, dtype, strided):
    """hymba-1.5b's chunk: H = 50 heads of P = 64, N = 16, Q = 256 (the
    serve path's bf16 views, and f32)."""
    args = _ssd_inputs(1, 256, 50, 64, 16, dtype, cuda, strided)
    for got, want in zip(SSK.ssd_chunk(*args), ssref.ssd_chunk_ref(*args)):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))


def test_ops_ssd_chunk_on_the_card_launches_the_kernel(cuda):
    args = _ssd_inputs(2, 16, 3, 8, 4, torch.float32, cuda)
    before = SSK.LAUNCHES["ssd_chunk"]
    ssops.ssd_chunk(*args)
    assert SSK.LAUNCHES["ssd_chunk"] == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,P,N", [
    (256, 64, 128), (32, 16, 16), (1, 1, 1), (300, 128, 256),
    (4000, 128, 256), (8000, 128, 256), (30000, 8, 4), (16, 129, 4),
    (16, 8, 257)])
def test_ssd_chunk_limits_match_the_library(cuda, Q, P, N, dtype):
    """The wrapper's copy of the kernel's tiles and limits refuses and
    sizes exactly what the built library does."""
    assert (SSK.library_smem_bytes(Q, P, N, dtype)
            == SSK.admitted_smem_bytes(Q, P, N, dtype))


def test_ssd_chunk_kernel_refuses_mixed_devices(cuda):
    x, dt, A, bm, cm, h = _ssd_inputs(2, 16, 3, 8, 4, torch.float32, cuda)
    with pytest.raises(ValueError, match="one CUDA device"):
        SSK.ssd_chunk(x, dt, A.cpu(), bm, cm, h)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_serve_on_the_card_matches_the_cpu(cuda, dtype):
    """The smoke model's prefill (a ragged last chunk) and 4 decode steps:
    kernels on the card, plain versions on the CPU, same weights."""
    import copy
    import dataclasses
    from repro_torch.config import smoke_config
    from repro_torch.models import init_params
    from repro_torch.runtime import steps
    cfg = dataclasses.replace(smoke_config("mamba2-370m"), dtype=dtype)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(cpu).to(cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 45)))
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    prefill, decode = steps.make_prefill_step(cfg), steps.make_decode_step(cfg)
    before = (RMK.LAUNCHES["rmsnorm"], SSK.LAUNCHES["ssd_chunk"])
    lc, cc = prefill(cpu, {"tokens": toks})
    lg, cg = prefill(card, {"tokens": toks.to(cuda)})
    L = cfg.n_layers
    assert RMK.LAUNCHES["rmsnorm"] == before[0] + 2 * L + 1
    assert SSK.LAUNCHES["ssd_chunk"] == before[1] + 2 * L   # 45 = 32 + 13
    for _ in range(4):
        torch.testing.assert_close(lg.cpu().float(), lc.float(), **tol)
        for k in ("ssm", "conv"):
            torch.testing.assert_close(cg[k].cpu().float(), cc[k].float(),
                                       **tol)
        # both sides decode the CPU's tokens; in float32 the card picks
        # the same ones (in bfloat16 a near tie may round either way)
        tok = torch.argmax(lc[:, :cfg.vocab_size], -1)[:, None]
        if dtype == "float32":
            assert torch.equal(
                torch.argmax(lg[:, :cfg.vocab_size], -1)[:, None].cpu(), tok)
        lc, cc = decode(cpu, tok, cc)
        lg, cg = decode(card, tok.to(cuda), cg)
    assert int(cg["pos"]) == 45 + 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-236b",
                                  "grok-1-314b", "hymba-1.5b",
                                  "whisper-small", "llava-next-mistral-7b"])
def test_family_serve_on_the_card_matches_the_cpu(cuda, arch, dtype):
    """One smoke model of each family: prefill (past hymba's window, and
    with an int8 cache where there is a K/V cache) and 4 decode steps,
    kernels on the card against plain versions on the CPU, same weights;
    B4 and B5 launch as the model's structure says (chip_smoke.py's
    count, at the repository's root)."""
    import copy
    import dataclasses

    from chip_smoke import rmsnorms_per_forward, ssd_chunks_per_prefill
    from repro_torch.config import smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.frontend import enc_len_for
    from repro_torch.runtime import steps
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(0)
    B, S = 2, 45
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (B, S)))}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model))).to(getattr(torch, dtype))
    if cfg.family == "encdec":
        batch["frame_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, enc_len_for(cfg, S), cfg.d_model))).to(getattr(torch, dtype))
    on_card = {k: v.to(cuda) for k, v in batch.items()}
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    total = S + 4 + (cfg.n_patches if cfg.family == "vlm" else 0)
    for q in (False, True):
        prefill = steps.make_prefill_step(cfg, quantize_kv_cache=q)
        decode = steps.make_decode_step(cfg)
        before = (RMK.LAUNCHES["rmsnorm"], SSK.LAUNCHES["ssd_chunk"])
        lc, cc = prefill(cpu, batch)
        lg, cg = prefill(card, on_card)
        assert RMK.LAUNCHES["rmsnorm"] == before[0] + \
            rmsnorms_per_forward(cfg)
        assert SSK.LAUNCHES["ssd_chunk"] == before[1] + \
            ssd_chunks_per_prefill(cfg, S)
        cc = steps.grow_decode_cache(cfg, cc, B, total, quantize_kv_cache=q)
        cg = steps.grow_decode_cache(cfg, cg, B, total, quantize_kv_cache=q)
        for _ in range(4):
            torch.testing.assert_close(lg.cpu().float(), lc.float(), **tol)
            tok = torch.argmax(lc[:, :cfg.vocab_size], -1)[:, None]
            lc, cc = decode(cpu, tok, cc)
            lg, cg = decode(card, tok.to(cuda), cg)
        torch.testing.assert_close(lg.cpu().float(), lc.float(), **tol)
        assert int(cg["pos"]) == total


# -- the energy path: the calibration and the Workload adapters on the card

def test_measured_calibration_on_the_card(cuda):
    from repro_torch.lqcd import measured_lqcd_calibration
    from repro_torch.power.model import H100_MEM_BOUND_W
    before = dict(K.LAUNCHES)
    cal = measured_lqcd_calibration((8, 8, 8, 8), reps=3, device="cuda")
    # 4 EO hops per A^dagger A, the warm-up application included
    assert K.LAUNCHES["dslash_eo_split"] == before["dslash_eo_split"] + 16
    assert K.LAUNCHES["dslash_split"] == before["dslash_split"]
    assert cal.source == "measured" and cal.n_devices == 1
    assert cal.gflops > 0 and cal.eff_bw_gbs > 0
    assert cal.busy_w == H100_MEM_BOUND_W
    assert cal.energy_j == pytest.approx(cal.busy_w * cal.wall_s, rel=1e-9)
    with pytest.raises(TypeError, match="LatticeMesh"):
        measured_lqcd_calibration((8, 8, 8, 8), mesh=object())


def test_lqcd_workload_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """The CPU's field on both devices: the card's solve goes through both
    D-slash kernels, as often as its iterations imply."""
    from repro_torch.cluster import workload as W
    from repro_torch.lqcd.su3 import random_field_and_source
    from repro_torch.power.model import OperatingPoint

    def cpu_field(shape, seed, device):
        U, b = random_field_and_source(shape, seed, "cpu")
        return U.to(device), b.to(device)

    monkeypatch.setattr(W, "random_field_and_source", cpu_field)
    op = OperatingPoint.green500()
    want = W.LQCDSolveWorkload(lattice=TL.SMOKE_LATTICE,
                               device="cpu").execute(op)
    before = dict(K.LAUNCHES)
    got = W.LQCDSolveWorkload(lattice=TL.SMOKE_LATTICE).execute(op)
    it, outer = got.details["iters"], got.details["outer_iters"]
    assert got.details["converged"] and got.details["rel_residual"] <= 1e-6
    assert abs(it - want.details["iters"]) <= 2
    assert K.LAUNCHES["dslash_eo_split"] == \
        before["dslash_eo_split"] + 4 * it + 4 * outer + 2
    assert K.LAUNCHES["dslash_split"] == before["dslash_split"] + 1
    t_end = float(got.power_trace.t[-1])
    assert got.energy_j == pytest.approx(
        got.power_trace.energy_j(t0=t_end - got.wall_s, t1=t_end), rel=1e-9)


def test_hpl_workload_and_run_on_the_card(cuda):
    from repro_torch.cluster import HPLWorkload, LQCDSolveWorkload, run
    from repro_torch.configs.hpl import HPLConfig
    from repro_torch.lqcd import measured_lqcd_calibration
    cal = measured_lqcd_calibration((8, 8, 8, 8), device="cuda")
    cfg = HPLConfig(n=512, block=64)
    steps = cfg.n // cfg.block
    before = G.LAUNCHES["dgemm"]
    res = run([LQCDSolveWorkload(lattice=TL.SMOKE_LATTICE, calibration=cal),
               HPLWorkload(cfg=cfg)])
    assert G.LAUNCHES["dgemm"] == before + (steps - 1) + (steps - 2)
    lq, hpl = res.results
    assert lq.details["converged"] and hpl.details["passed"]
    assert lq.details["calibration_source"] == "measured"
    assert lq.energy_j == pytest.approx(cal.busy_w * lq.wall_s, rel=1e-9)
    for r in res.results:
        t_end = float(r.power_trace.t[-1])
        assert r.energy_j == pytest.approx(
            r.power_trace.energy_j(t0=t_end - r.wall_s, t1=t_end), rel=1e-9)
        assert r.gflops_per_w > 0


# -- the online simulator and the executed replay on the card

def test_executed_runtime_on_the_card_matches_the_cpu(cuda):
    """mamba2-370m cut to 2 layers at full width (bf16, the serve
    path's dtype) through ``ExecutedGroupRuntime``: kernels on the card,
    plain versions on the CPU, the same weights and prompt stream.  Seed
    37's narrowest greedy choice at batch 1, prompt 300, is a top-2
    logit gap of 4 bf16 ulps (chip_smoke.py phase 11), so both pick the
    same tokens."""
    import copy
    import dataclasses
    from repro_torch.config import full_config
    from repro_torch.models import init_params
    from repro_torch.serve import ExecutedGroupRuntime
    cfg = dataclasses.replace(full_config("mamba2-370m"), n_layers=2)
    cpu = init_params(cfg, torch.Generator().manual_seed(37), "cpu")
    card = copy.deepcopy(cpu).to(cuda)
    a = ExecutedGroupRuntime(cfg=cfg, params=cpu, seed=37, device="cpu")
    b = ExecutedGroupRuntime(cfg=cfg, params=card, seed=37, device=cuda)
    before = (RMK.LAUNCHES["rmsnorm"], SSK.LAUNCHES["ssd_chunk"])
    got, want = b.run_group(300, 9, 1), a.run_group(300, 9, 1)
    assert np.array_equal(got, want)
    assert got.shape == (1, 9) and np.all(got < cfg.vocab_size)
    L = cfg.n_layers
    assert RMK.LAUNCHES["rmsnorm"] == before[0] + (2 * L + 1) * 10
    assert SSK.LAUNCHES["ssd_chunk"] == before[1] + L * 2     # 300 = 256 + 44


def test_executed_simulation_on_the_card_keeps_the_trace(cuda):
    """``simulate(..., execute=True)`` runs HPL (B3) and the LQCD solve
    (B1, B2) on the card after the event loop, with a failure that kills
    an HPL attempt: its placements, stats and trace equal
    ``execute=False``'s, every completed uid has a result, and the
    kernels launch as the results' steps and iterations imply."""
    import dataclasses
    from repro_torch.cluster import (CheckpointPolicy, ClusterTopology,
                                     HPLWorkload, LQCDSolveWorkload,
                                     simulate)
    from repro_torch.configs.hpl import HPLConfig
    from repro_torch.distributed.fault import WeibullFailureModel
    hc = HPLConfig(n=512, block=64)

    def arrivals():
        return [(0.0, HPLWorkload(cfg=hc)),
                (60.0, LQCDSolveWorkload(lattice=TL.SMOKE_LATTICE)),
                (120.0, LQCDSolveWorkload(name="lqcd2", seed=1,
                                          lattice=TL.SMOKE_LATTICE)),
                (300.0, HPLWorkload(name="hpl2", cfg=hc))]

    kw = dict(topology=ClusterTopology(n_nodes=2), dt_s=30.0,
              failure_model=WeibullFailureModel(mtbf_s=1000.0, shape=1.0,
                                                repair_s=300.0),
              seed=3, checkpoint=CheckpointPolicy())
    plain = simulate(arrivals(), **kw)
    before = (dict(K.LAUNCHES), G.LAUNCHES["dgemm"])
    ex = simulate(arrivals(), execute=True, **kw)
    assert ex.stats.requeues >= 1 and not plain.results
    assert [(p.job.name, p.start, p.end, tuple(p.chips))
            for p in ex.schedule.placements] == \
        [(p.job.name, p.start, p.end, tuple(p.chips))
         for p in plain.schedule.placements]
    assert dataclasses.asdict(ex.stats) == dataclasses.asdict(plain.stats)
    assert np.array_equal(ex.trace.t, plain.trace.t)
    for k in plain.trace.components:
        assert np.array_equal(ex.trace.components[k],
                              plain.trace.components[k])
    done = [r.uid for r in ex.records if r.state == "completed"]
    assert sorted(ex.results) == done == [0, 1, 2, 3]
    eo = full = gemm = 0
    for r in ex.results.values():
        if r.kind == "hpl":
            assert r.details["passed"]
            steps = hc.n // hc.block
            gemm += (steps - 1) + (steps - 2)
        else:
            assert r.details["converged"]
            eo += 4 * r.details["iters"] + 4 * r.details["outer_iters"] + 2
            full += 1
    assert K.LAUNCHES["dslash_eo_split"] == before[0]["dslash_eo_split"] + eo
    assert K.LAUNCHES["dslash_split"] == before[0]["dslash_split"] + full
    assert G.LAUNCHES["dgemm"] == before[1] + gemm


# the train step: B4 and B5 under autograd (their autograd.Functions run
# the kernel forward and autograd of the plain version backward)
@pytest.mark.parametrize("rows,d,dtype", [
    (4096, 1024, torch.bfloat16),     # mamba2's norms, a 2 x 2048 microbatch
    (4096, 2048, torch.float32),      # its gated norm
    (4096, 4096, torch.bfloat16),     # llama3-8b's norms at 2 x 2048
    (8192, 1024, torch.bfloat16)])    # the serve path's prefill norm
def test_rmsnorm_function_gradients_on_the_card(cuda, rows, d, dtype):
    """One forward launch, none in backward; the output within the
    kernel's tolerance of the plain version's, the gradients equal to
    autograd of the plain version on the same inputs (the Function's
    backward is that computation)."""
    x, w = _rms_case(rows, d, dtype, torch.bfloat16, cuda)
    x, w = x.requires_grad_(), w.requires_grad_()
    before = RMK.LAUNCHES["rmsnorm"]
    y = rmops.rmsnorm(x, w)
    assert RMK.LAUNCHES["rmsnorm"] == before + 1
    gy = torch.randn_like(y)
    got = torch.autograd.grad(y, (x, w), gy)
    assert RMK.LAUNCHES["rmsnorm"] == before + 1
    yr = rmref.rmsnorm_ref(x, w)
    want = torch.autograd.grad(yr, (x, w), gy)
    tol = RMS_TOL[dtype]
    torch.testing.assert_close(y.float(), yr.float(), rtol=tol, atol=tol)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("B,Q,H,P,N", [(2, 256, 32, 64, 128),
                                       (1, 256, 50, 64, 16)])
def test_ssd_chunk_function_gradients_on_the_card(cuda, B, Q, H, P, N):
    """mamba2's chunk at a 2 x 2048 microbatch and hymba's, x, B and C
    bf16 views of one conv output: one forward launch, none in backward,
    the gradients of every input equal to autograd of the plain
    version's."""
    g = torch.Generator().manual_seed(Q + H)
    conv = torch.randn(B, Q, H * P + 2 * N, generator=g).to(cuda,
                                                           torch.bfloat16)
    dt = torch.nn.functional.softplus(torch.randn(B, Q, H, generator=g))
    A = -torch.exp(torch.randn(H, generator=g) * 0.3)
    h = torch.randn(B, H, P, N, generator=g)
    leaves = [t.to(cuda).requires_grad_() for t in (conv, dt, A, h)]

    def views(conv, dt, A, h):
        return (conv[..., :H * P].reshape(B, Q, H, P), dt, A,
                conv[..., H * P:H * P + N], conv[..., H * P + N:], h)

    before = SSK.LAUNCHES["ssd_chunk"]
    y, hn = ssops.ssd_chunk(*views(*leaves))
    assert SSK.LAUNCHES["ssd_chunk"] == before + 1
    gy, gh = torch.randn_like(y), torch.randn_like(hn)
    got = torch.autograd.grad((y, hn), leaves, (gy, gh))
    assert SSK.LAUNCHES["ssd_chunk"] == before + 1
    want = torch.autograd.grad(ssref.ssd_chunk_ref(*views(*leaves)), leaves,
                               (gy, gh))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_forward_launches_with_and_without_grad(cuda):
    """The mamba2 smoke model's forward launches B4 and B5 as often with
    autograd recording (trainable parameters) as under inference_mode,
    and its backward launches neither."""
    import copy
    from repro_torch.config import smoke_config
    from repro_torch.models import init_params
    from repro_torch.models.transformer import forward_hidden
    cfg = smoke_config("mamba2-370m")
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 45),
                                     device=cuda)}
    counts = []
    for grad in (False, True):
        model = copy.deepcopy(p).requires_grad_() if grad else p
        before = (RMK.LAUNCHES["rmsnorm"], SSK.LAUNCHES["ssd_chunk"])
        with torch.inference_mode(not grad):
            h = forward_hidden(cfg, model, batch)[0]
        counts.append((RMK.LAUNCHES["rmsnorm"] - before[0],
                       SSK.LAUNCHES["ssd_chunk"] - before[1]))
        if grad:
            h.float().sum().backward()
            assert (RMK.LAUNCHES["rmsnorm"], SSK.LAUNCHES["ssd_chunk"]) == \
                (before[0] + counts[-1][0], before[1] + counts[-1][1])
    assert counts[0] == counts[1] == (2 * cfg.n_layers + 1, 2 * cfg.n_layers)


@pytest.mark.parametrize("arch", ["mamba2-370m", "llama3-8b", "hymba-1.5b",
                                  "deepseek-v2-236b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One float32 loss and its gradients (remat "layer"), then a train
    step, on the CPU (plain versions) and the card (kernels), same
    weights: the loss and the gradient norm within 1e-4, each gradient
    leaf within 1e-3 of its largest value (chip_smoke.py's [18d]; B5's
    own f32 sums put mamba2's A_log gradient, summed over every
    position, ~1.1e-4 of its largest value apart)."""
    import copy
    import dataclasses
    from repro_torch.config import TrainConfig, smoke_config
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.steps import loss_and_grads, make_train_step
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    tc = TrainConfig(warmup_steps=1, learning_rate=3e-3)
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    b = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 45)))
         for k in ("tokens", "labels")}
    out = {}
    for where, p in (("cpu", cpu), ("card", copy.deepcopy(cpu).to(cuda))):
        bb = {k: v.to(p.embed.tokens.device) for k, v in b.items()}
        loss, _, g = loss_and_grads(cfg, tc, p.requires_grad_(), bb)
        _, _, m = make_train_step(cfg, tc)(p, adamw_init(p), bb)
        out[where] = (float(loss), g, float(m["grad_norm"]))
    (lc, gc, nc), (lg, gg, ng) = out["cpu"], out["card"]
    assert lg == pytest.approx(lc, rel=1e-4)
    assert ng == pytest.approx(nc, rel=1e-4)
    for k, a in gc.items():
        scale = float(a.abs().max())
        assert float((gg[k].cpu() - a).abs().max()) <= 1e-3 * scale, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_manager_on_cuda_tensors(cuda, tmp_path, monkeypatch,
                                            dtype):
    """A tree of CUDA tensors saves in the JAX package's format (bfloat16
    widened to float32 on disk, "bfloat16" in the manifest), restores on
    the card in its dtype bit for bit, and the host snapshot is the
    checkpoint's own: tensors written on the card between save() and
    the writer's first leaf leave it unchanged."""
    import json
    import threading
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as M
    dt = getattr(torch, dtype)
    g = torch.Generator(cuda).manual_seed(0)
    tree = {"w": torch.randn(64, 33, generator=g, device=cuda).to(dt),
            "opt": {"m": torch.randn(7, generator=g, device=cuda)}}
    old = {"w": tree["w"].clone(), "m": tree["opt"]["m"].clone()}
    go, to_numpy = threading.Event(), M._to_numpy
    monkeypatch.setattr(M, "_to_numpy",
                        lambda a: (go.wait(timeout=60), to_numpy(a))[1])
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, tree)
    tree["w"].mul_(-3)
    tree["opt"]["m"].zero_()
    go.set()
    mgr.wait()
    man = json.loads((tmp_path / "step_00000003" / "manifest.json")
                     .read_text())
    assert man["leaves"]["w"]["dtype"] == dtype
    assert np.load(tmp_path / "step_00000003" /
                   man["leaves"]["w"]["file"]).dtype == np.float32
    got = mgr.restore(3, tree)
    assert got["w"].device.type == "cuda" and got["w"].dtype == dt
    assert torch.equal(got["w"], old["w"])
    assert torch.equal(got["opt"]["m"], old["m"])


def test_train_driver_on_the_card(cuda, tmp_path):
    """Two steps of ``launch.train`` on the card (mamba2's smoke config):
    finite losses, B4 and B5 launched, a checkpoint of step 0 that
    restores bit for bit into a fresh model on the card."""
    from repro_torch.config import smoke_config
    from repro_torch.launch import train
    rms, ssd = RMK.LAUNCHES["rmsnorm"], SSK.LAUNCHES["ssd_chunk"]
    run = train.main(["--arch", "mamba2-370m", "--steps", "2", "--batch",
                      "2", "--seq", "64", "--ckpt-every", "1",
                      "--ckpt-dir", str(tmp_path), "--device", "cuda"])
    assert RMK.LAUNCHES["rmsnorm"] > rms and SSK.LAUNCHES["ssd_chunk"] > ssd
    assert all(np.isfinite(h.loss) for h in run.loop.history)
    assert run.ckpt.steps() == [0, 1]
    like = train.make_params(smoke_config("mamba2-370m"), 5, cuda)
    got = run.ckpt.restore(1, like)
    for (k, a), (_, b) in zip(run.params.named_parameters(),
                              got.named_parameters()):
        assert b.device.type == "cuda" and torch.equal(a, b), k
