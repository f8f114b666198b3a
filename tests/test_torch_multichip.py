"""The port's T-sharded LQCD path against the JAX package's, on the CPU.

Fields are drawn once with the reference's ``jax.random`` (as
``tests/test_multichip_eo.py`` draws them) and converted.  The port's
mesh holds its shards on the CPU (``lattice_mesh(T, n, devices=("cpu",))``),
the reference's on the virtual CPU devices ``conftest`` sets up.  The
reference's sharded *solve* fails on this jax (ROADMAP C), so the port's
sharded solve is held against both packages' ``mesh=None`` solves.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import need_devices  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.lqcd import cg as JC  # noqa: E402
from repro.lqcd import eo as JE  # noqa: E402
from repro.lqcd import multichip as JM  # noqa: E402
from repro.lqcd import multichip_eo as JMC  # noqa: E402
from repro.lqcd.su3 import random_su3_field  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import SolverConfig  # noqa: E402
from repro_torch.distributed import sharding as TSH  # noqa: E402
from repro_torch.kernels.dslash.ops import (dslash_half_op,  # noqa: E402
                                            dslash_op)
from repro_torch.lqcd import cg as TC  # noqa: E402
from repro_torch.lqcd import eo as TE  # noqa: E402
from repro_torch.lqcd import multichip as TM  # noqa: E402
from repro_torch.lqcd import multichip_eo as TMC  # noqa: E402
from repro_torch.power.model import H100_MEM_BOUND_W  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)     # the reference test's
X_TOL = dict(rtol=1e-3, atol=1e-4)   # solutions to solver accuracy


@functools.lru_cache(maxsize=None)
def _fields(lat, seed=0):
    """The reference test's fields: (U, b) as numpy and as CPU tensors."""
    ku, kr, ki = jax.random.split(jax.random.PRNGKey(seed), 3)
    U = random_su3_field(ku, lat)
    b = (jax.random.normal(kr, lat + (4, 3))
         + 1j * jax.random.normal(ki, lat + (4, 3))).astype(jnp.complex64)
    U, b = np.asarray(U), np.asarray(b)
    return (U, b, convert.gauge_from_numpy(U, "cpu"),
            convert.spinor_from_numpy(b, "cpu"))


@functools.lru_cache(maxsize=None)
def _halves(lat, seed=0):
    """Packed gauge halves of both packages: (J U_e, J U_o, T U_e, T U_o)."""
    U, _, tU, _ = _fields(lat, seed)
    return JE.pack_gauge(jnp.asarray(U)) + TE.pack_gauge(tU)


BIG = (12, 12, 12, 24)
BIG_SEED = 5                         # the reference's larger-lattice test


def _seed(lat):
    return BIG_SEED if lat == BIG else 0


@functools.lru_cache(maxsize=None)
def _jax_solve(lat, seed, kappa, tol, max_iters, inner):
    """The reference's mesh=None solve (shared by the parametrised cases)."""
    U, b, _, _ = _fields(lat, seed)
    return JC.solve_wilson_eo(jnp.asarray(U), jnp.asarray(b), kappa, tol=tol,
                              max_iters=max_iters,
                              inner_dtype=inner and jnp.bfloat16)


@functools.lru_cache(maxsize=None)
def _port_solve(lat, seed, kappa, tol, max_iters, inner):
    """The port's mesh=None solve."""
    _, _, tU, tb = _fields(lat, seed)
    return TC.solve_wilson_eo(tU, tb, kappa, tol=tol, max_iters=max_iters,
                              inner_dtype=inner and torch.bfloat16)


def _mesh(t, n):
    return TSH.lattice_mesh(t, n, devices=("cpu",))


def _close(got, want, **tol):
    np.testing.assert_allclose(convert.to_numpy(got), np.asarray(want),
                               **(tol or TOL))


# -- the mesh -----------------------------------------------------------------

@pytest.mark.parametrize("n", range(1, 9))
def test_halo_perms_match_jax(n):
    assert TM.halo_perms(n) == JM.halo_perms(n)
    assert TM.halo_perms(n) is TM.halo_perms(n)


@pytest.mark.parametrize("t_extent", [1, 6, 7, 8, 12, 16, 24])
def test_lattice_mesh_picks_the_jax_count(t_extent):
    need_devices(8)
    for n in range(1, 9):
        want = JSH.lattice_mesh(t_extent, n).shape["model"]
        got = _mesh(t_extent, n)
        assert got.n == want
        assert got.devices == (torch.device("cpu"),) * want


def test_lattice_mesh_places_shards_round_robin(monkeypatch):
    """Shards go round-robin over the cards (no tensor is made here)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = TSH.lattice_mesh(12, 6)
    cards = (torch.device("cuda", 0), torch.device("cuda", 1))
    assert mesh.n == 6 and mesh.devices == cards * 3
    assert mesh.distinct_devices == cards
    assert TSH.lattice_mesh(64, 4).devices == cards * 2
    with pytest.raises(ValueError, match="one type"):
        TSH.lattice_mesh(8, 2, devices=("cpu", "cuda:0"))
    # no card and no devices named: refuse, as the port's entry points do
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="devices=\\('cpu',\\)"):
        TSH.lattice_mesh(8, 4)


def test_split_and_gather_t_blocks_round_trip():
    _, b, _, tb = _fields((4, 4, 4, 8))
    g_ax, p_ax = TSH.lattice_eo_specs()
    assert (g_ax, p_ax) == (4, 3)
    # the reference's specs split the same axes
    u_spec, p_spec = JSH.lattice_eo_specs("model")
    assert u_spec[g_ax] == p_spec[p_ax] == "model"
    psi = TE.eo_pack(tb, 0)
    blocks = TSH.split_t_blocks(psi, _mesh(8, 4), p_ax)
    assert [tuple(x.shape) for x in blocks] == [(2, 4, 4, 2, 4, 3)] * 4
    assert all(x.is_contiguous() for x in blocks)
    assert torch.equal(TSH.gather_t_blocks(blocks, p_ax, "cpu"), psi)


# -- the sharded even-odd hop -------------------------------------------------

@pytest.mark.parametrize("lat", [(8, 8, 8, 8), BIG])
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_eo_dslash_matches_jax(lat, ndev):
    """The port's plain hop against both of the reference's halo
    formulations (``overlap`` True and False), both source parities."""
    need_devices(ndev)
    _, b, _, tb = _fields(lat, _seed(lat))
    jU_e, jU_o, tU_e, tU_o = _halves(lat, _seed(lat))
    jmesh, tmesh = JSH.lattice_mesh(lat[3], ndev), _mesh(lat[3], ndev)
    for src_parity in (0, 1):
        jpsi = JE.eo_pack(jnp.asarray(b), src_parity)
        tpsi = TE.eo_pack(tb, src_parity)
        got = TMC.dslash_half_sharded(tU_e, tU_o, tpsi, src_parity, tmesh)
        for overlap in (True, False):
            want = JMC.dslash_half_sharded(jU_e, jU_o, jpsi, src_parity,
                                           jmesh, overlap=overlap)
            _close(got, want)


@pytest.mark.parametrize("lat,ndev", [((8, 8, 8, 8), 2), ((8, 8, 8, 8), 4),
                                      (BIG, 2), (BIG, 4)])
def test_sharded_eo_kernel_path_matches_jax_pallas(lat, ndev):
    """The padded path (the plain EO hop on the CPU) against the
    reference's Pallas path; and, since every real row of a padded block
    reads the one-device operands in the same order, exactly equal to the
    port's one-device hop on the same split layout."""
    need_devices(ndev)
    _, b, _, tb = _fields(lat, _seed(lat))
    jU_e, jU_o, tU_e, tU_o = _halves(lat, _seed(lat))
    jmesh, tmesh = JSH.lattice_mesh(lat[3], ndev), _mesh(lat[3], ndev)
    for src_parity in (0, 1):
        jpsi = JE.eo_pack(jnp.asarray(b), src_parity)
        tpsi = TE.eo_pack(tb, src_parity)
        want = JMC.dslash_half_sharded(jU_e, jU_o, jpsi, src_parity, jmesh,
                                       backend="pallas")
        got = TMC.dslash_half_sharded(tU_e, tU_o, tpsi, src_parity, tmesh,
                                      backend="kernel")
        _close(got, want, rtol=1e-4, atol=1e-4)
        assert torch.equal(got, dslash_half_op(tU_e, tU_o, tpsi, src_parity))


def test_odd_local_t_extent_supported():
    """8^4 over 8 shards leaves T_local = 1: the global-t parity shift
    keeps the x-hop pattern alternating across shards (plain path)."""
    need_devices(8)
    lat = (8, 8, 8, 8)
    _, b, _, tb = _fields(lat, seed=1)
    jU_e, jU_o, tU_e, tU_o = _halves(lat, seed=1)
    want = JMC.dslash_half_sharded(jU_e, jU_o, JE.eo_pack(jnp.asarray(b), 1),
                                   1, jax.make_mesh((8,), ("model",)))
    got = TMC.dslash_half_sharded(tU_e, tU_o, TE.eo_pack(tb, 1), 1,
                                  _mesh(8, 8))
    _close(got, want)
    assert _mesh(8, 8).n == 8


def test_sharded_operators_match_jax():
    """schur, schur_dagger, normal, rhs and reconstruct on 4 shards."""
    need_devices(4)
    lat, kappa = (8, 8, 8, 8), 0.12
    _, b, _, tb = _fields(lat, seed=4)
    jU_e, jU_o, tU_e, tU_o = _halves(lat, seed=4)
    jops = JMC.ShardedWilsonEO(jU_e, jU_o, kappa, JSH.lattice_mesh(8, 4))
    tops = TMC.ShardedWilsonEO(tU_e, tU_o, kappa, _mesh(8, 4))
    jb_e, jb_o = JE.eo_pack(jnp.asarray(b), 0), JE.eo_pack(jnp.asarray(b), 1)
    tb_e, tb_o = TE.eo_pack(tb, 0), TE.eo_pack(tb, 1)
    for name in ("schur", "schur_dagger", "normal"):
        _close(getattr(tops, name)(tb_e), getattr(jops, name)(jb_e))
    _close(tops.rhs(tb_e, tb_o), jops.rhs(jb_e, jb_o))
    _close(tops.reconstruct(tb_e, tb_o), jops.reconstruct(jb_e, jb_o))


# -- the sharded inner CG -----------------------------------------------------

@pytest.mark.parametrize("inner", [None, "bfloat16"])
@pytest.mark.parametrize("ndev", [2, 4])
def test_cg_normal_matches_jax(ndev, inner):
    need_devices(ndev)
    lat, kappa, tol = (8, 8, 8, 8), 0.12, 1e-6
    _, b, _, tb = _fields(lat, seed=4)
    jU_e, jU_o, tU_e, tU_o = _halves(lat, seed=4)
    jops = JMC.ShardedWilsonEO(jU_e, jU_o, kappa, JSH.lattice_mesh(8, ndev))
    tops = TMC.ShardedWilsonEO(tU_e, tU_o, kappa, _mesh(8, ndev))
    want = jops.cg_normal(JE.eo_pack(jnp.asarray(b), 0), tol=tol,
                          max_iters=400,
                          inner_dtype=inner and jnp.bfloat16)
    got = tops.cg_normal(TE.eo_pack(tb, 0), tol=tol, max_iters=400,
                         inner_dtype=inner and torch.bfloat16)
    assert got.iters == int(want.iters)
    assert got.converged == bool(want.converged)
    assert got.rel_residual == pytest.approx(float(want.rel_residual),
                                             rel=0.05)
    if inner is None:
        _close(got.x, want.x, **X_TOL)
        return
    # a bf16 inner solve: a last-ulp difference in f32 flips a bf16
    # rounding here and there (one element off by 7.4e-3), so x is held
    # at rtol 1e-3 normwise (measured 2.3e-4 to 2.5e-4)
    gx, wx = convert.to_numpy(got.x), np.asarray(want.x)
    assert np.linalg.norm(gx - wx) <= 1e-3 * np.linalg.norm(wx)


# -- the sharded full D-slash -------------------------------------------------

@pytest.mark.parametrize("compress", [True, False])
def test_dslash_sharded_matches_jax(compress):
    need_devices(4)
    U, b, tU, tb = _fields((4, 4, 4, 8), seed=7)
    # jitted: the reference's shard_map runs op by op (~6 s) without it
    want = jax.jit(functools.partial(
        JM.dslash_sharded, mesh=JSH.lattice_mesh(8, 4),
        compress=compress))(jnp.asarray(U), jnp.asarray(b))
    got = TM.dslash_sharded(tU, tb, _mesh(8, 4), compress=compress)
    _close(got, want)


@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_compressed_halos_bit_compatible(ndev):
    """Half the spinor halo bytes, the same result bit for bit; and, since
    every real row of a padded block reads the one-device operands in the
    same order, equal to the one-device hop on the same layout (T_local
    2, 1 for 8 shards: the full hop takes odd local extents)."""
    lat = (4, 4, 4, 8)
    _, _, tU, tb = _fields(lat, seed=7)
    mesh = _mesh(8, ndev)
    c = TM.dslash_sharded(tU, tb, mesh, compress=True)
    u = TM.dslash_sharded(tU, tb, mesh, compress=False)
    assert torch.equal(c, u)
    assert torch.equal(c, dslash_op(tU, tb))


# -- the sharded solve --------------------------------------------------------

@pytest.mark.parametrize("inner", [None, "bfloat16"])
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_sharded_eo_cg_matches_single_device(ndev, inner):
    """The reference test's sizes and tolerances, against the port's and
    the reference's mesh=None solves."""
    lat, kappa, tol = (8, 8, 8, 8), 0.12, 1e-6
    _, _, tU, tb = _fields(lat, seed=4)
    want = _jax_solve(lat, 4, kappa, tol, 400, inner)
    one = _port_solve(lat, 4, kappa, tol, 400, inner)
    got = TC.solve_wilson_eo(tU, tb, kappa, tol=tol, max_iters=400,
                             inner_dtype=inner and torch.bfloat16,
                             mesh=_mesh(8, ndev))
    assert want.converged and one.converged and got.converged
    assert got.rel_residual <= tol
    slack = 2 if inner else 1       # reduction order (PERF.md §2)
    for ref in (want, one):
        assert abs(got.iters - int(ref.iters)) <= slack
        assert abs(got.outer_iters - ref.outer_iters) <= 1
        _close(got.x, ref.x, **X_TOL)


def test_sharded_eo_cg_larger_lattice():
    _, _, tU, tb = _fields(BIG, BIG_SEED)
    got = TC.solve_wilson_eo(tU, tb, 0.1, tol=1e-5, max_iters=300,
                             mesh=_mesh(24, 8))
    assert got.converged and got.rel_residual <= 1e-5
    for ref in (_jax_solve(BIG, BIG_SEED, 0.1, 1e-5, 300, None),
                _port_solve(BIG, BIG_SEED, 0.1, 1e-5, 300, None)):
        assert abs(got.iters - int(ref.iters)) <= 1
        _close(got.x, ref.x, **X_TOL)


def test_solve_dirac_mesh_dispatch():
    """The reference test's dispatch case, against the port's mesh=None
    solve (itself held against the reference's in test_torch_solver)."""
    _, _, tU, tb = _fields((4, 4, 4, 8), seed=6)
    mesh = _mesh(8, 4)
    cfg = SolverConfig(preconditioner="even_odd", tol=1e-5, max_iters=300)
    got = TC.solve_dirac(tU, tb, 0.1, cfg, mesh=mesh)
    want = TC.solve_dirac(tU, tb, 0.1, cfg)
    assert got.converged and got.rel_residual <= 1e-5
    assert abs(got.iters - want.iters) <= 1
    _close(got.x, want.x, **X_TOL)
    with pytest.raises(ValueError, match="even-odd"):
        TC.solve_dirac(tU, tb, 0.1, SolverConfig(preconditioner="none"),
                       mesh=mesh)


# -- the calibration on a mesh ------------------------------------------------

def test_measured_calibration_on_a_mesh():
    cal = TMC.measured_lqcd_calibration((4, 4, 4, 8), reps=2,
                                        mesh=_mesh(8, 4), device="cpu")
    assert cal.source == "measured"
    assert cal.gflops > 0 and cal.eff_bw_gbs > 0 and cal.wall_s > 0
    assert cal.gflops_per_w == pytest.approx(cal.gflops / cal.busy_w)
    assert cal.trace is not None
    assert cal.energy_j == pytest.approx(cal.busy_w * cal.wall_s, rel=1e-6)
    # by design: four shards on one device bill one device (the reference
    # counts the mesh size, 4)
    assert cal.n_devices == 1
    assert cal.busy_w == H100_MEM_BOUND_W


# -- refusals -----------------------------------------------------------------

def test_invalid_shardings_raise():
    _, _, tU, _ = _fields((4, 4, 4, 8))
    U_e, U_o = TE.pack_gauge(tU)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="not divisible"):
        TMC.ShardedWilsonEO(U_e, U_o, 0.1, TSH.LatticeMesh((cpu,) * 3))
    # the kernel path needs an even local T extent (the pad shifts parity)
    with pytest.raises(ValueError, match="even local T"):
        TMC.ShardedWilsonEO(U_e, U_o, 0.1, _mesh(8, 8), backend="kernel")
    for backend in ("rocm", "plain", "pallas"):
        with pytest.raises(ValueError, match="unknown backend"):
            TMC.ShardedWilsonEO(U_e, U_o, 0.1, _mesh(8, 2), backend=backend)
    with pytest.raises(TypeError, match="LatticeMesh"):
        TMC.ShardedWilsonEO(U_e, U_o, 0.1, object())
    # the plain path takes odd local T extents
    assert TMC.ShardedWilsonEO(U_e, U_o, 0.1, _mesh(8, 8)).t_local == 1
