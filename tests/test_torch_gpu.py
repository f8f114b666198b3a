"""The port's CUDA kernels, its solve, its LU and its mamba2 serve path on
the card.  Every test here is marked ``gpu`` and skips without a CUDA
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
from repro_torch.kernels.dgemm import kernel as G  # noqa: E402
from repro_torch.kernels.dgemm import ops as gops  # noqa: E402
from repro_torch.kernels.dgemm import ref as gref  # noqa: E402
from repro_torch.kernels.dslash import kernel as K  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as RMK  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rmops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rmref  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as SSK  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops as ssops  # noqa: E402
from repro_torch.kernels.ssd_chunk import ref as ssref  # noqa: E402
from repro_torch.kernels.dslash import ops, ref  # noqa: E402
from repro_torch.distributed import lattice_mesh  # noqa: E402
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


# -- the T-sharded path: several shards on the card -----------------------


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("lattice", [(8, 8, 8, 16), (16, 8, 8, 8)])
def test_sharded_eo_hop_equals_the_one_device_kernel(cuda, lattice, n):
    """Every real row of a padded block reads the one-device operands in
    the same order: the cropped hops equal B1's one-device hop bit for
    bit, one B1 launch per shard."""
    U, psi = _fields(lattice, cuda)
    U_e, U_o = TE.pack_gauge(U)
    mesh = lattice_mesh(lattice[3], n)
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
    # 4 per inner normal op; the rhs; one one-device hop to reconstruct
    assert launches == n * (4 * got.iters + 4 * got.outer_iters + 1) + 1
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
