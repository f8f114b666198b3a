"""The port's LQCD solve on T-slabs (``solve_dirac(U_slabs, b_slabs, ...,
mesh=)``) and the plain reference in slabs that judges it, on the CPU:
the slab solve against the one-device solve on the field the slabs make
up, over 2 and 4 CPU places with the plain hop and the padded (kernel)
hop; the slab reference against the whole-lattice reference; the
benchmark's per-row field generators; the four-card configuration's
control; the four-card cell itself at its tiny size over four CPU places,
its readers, and the room it makes in the power sampler's pipe.
"""
import functools
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

# the benchmark's package (lcsc_bench) sits at the repository's root
ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from lcsc_bench.drivers import lqcd_slabs  # noqa: E402
from lcsc_bench.lib import sampler_pipe, slabs, spec  # noqa: E402
from lcsc_bench.lib.spec import load_json  # noqa: E402
from lcsc_bench.reference import wilson, wilson_slabs  # noqa: E402
from repro_torch.config import SolverConfig  # noqa: E402
from repro_torch.configs.lcsc_lqcd import EO_MIXED_SOLVER  # noqa: E402
from repro_torch.distributed import LatticeMesh, lattice_mesh  # noqa: E402
from repro_torch.lqcd import cg as TC  # noqa: E402
from repro_torch.lqcd import multichip_eo as TMC  # noqa: E402

LATTICE = (4, 4, 4, 8)
KAPPA = 0.137
SEED = 2 ** 33 + 5
CONFIG = ROOT / "lcsc_bench" / "configs" / "lqcd-cold-64c128.json"


@functools.lru_cache(maxsize=None)
def _fields(n, seed=SEED):
    """The gauge field and a source, as ``n`` T-slabs on the CPU."""
    cpu = ["cpu"] * n
    return (slabs.su3_field(seed, LATTICE, cpu),
            slabs.spinor(seed + 1, LATTICE, cpu))


def _whole(parts, axis):
    return torch.cat(list(parts), axis)


@functools.lru_cache(maxsize=None)
def _one_device():
    U, b = _fields(1)
    return TC.solve_dirac(U[0], b[0], KAPPA, EO_MIXED_SOLVER)


@pytest.mark.parametrize("backend", [None, "kernel"])
@pytest.mark.parametrize("n", [2, 4])
def test_slab_solve_equals_the_one_device_solve(n, backend):
    """EO_MIXED on slabs: the slab reference's true residual (complex128)
    at most 1e-6, the one-device solve's iteration counts, and its x to
    1e-5 of |x|; ``backend=None`` is the CPU's plain hop through
    ``solve_dirac``, ``"kernel"`` B1's halo-padded blocks through the
    plain EO hop."""
    U, b = _fields(n)
    mesh = lattice_mesh(LATTICE[3], n, devices=("cpu",))
    if backend is None:
        got = TC.solve_dirac(U, b, KAPPA, EO_MIXED_SOLVER, mesh=mesh)
    else:
        cfg = EO_MIXED_SOLVER
        got = TMC.solve_wilson_eo_slabs(
            U, b, KAPPA, mesh, tol=cfg.tol, max_iters=cfg.max_iters,
            inner_dtype=torch.bfloat16, inner_tol=cfg.inner_tol,
            max_outer=cfg.max_outer, backend=backend)
    assert isinstance(got.x, list) and len(got.x) == n
    assert all(tuple(x.shape) == tuple(v.shape) for x, v in zip(got.x, b))
    assert got.converged and got.rel_residual <= 1e-6
    op = wilson_slabs.SlabWilson(U, KAPPA)
    assert wilson_slabs.true_residual(op, got.x, b) <= 1e-6
    one = _one_device()
    assert one.outer_iters >= 2
    assert (got.iters, got.outer_iters) == (one.iters, one.outer_iters)
    x = _whole(got.x, 3)
    assert float((x - one.x).norm() / one.x.norm()) <= 1e-5


def test_whole_tensor_mesh_solve_is_the_slab_solve():
    """``solve_wilson_eo(mesh=)`` cuts its inputs into the mesh's slabs,
    runs the slab solve and gathers x: the same numbers as the slab
    entry point."""
    U, b = _fields(4)
    mesh = lattice_mesh(LATTICE[3], 4, devices=("cpu",))
    whole = TC.solve_dirac(_whole(U, 4), _whole(b, 3), KAPPA,
                           EO_MIXED_SOLVER, mesh=mesh)
    got = TC.solve_dirac(U, b, KAPPA, EO_MIXED_SOLVER, mesh=mesh)
    assert (got.iters, got.outer_iters, got.rel_residual) == \
        (whole.iters, whole.outer_iters, whole.rel_residual)
    assert torch.equal(_whole(got.x, 3), whole.x)


def test_slab_solve_refuses_misplaced_slabs():
    U, b = _fields(2)
    with pytest.raises(ValueError, match="T-slabs for a 4-shard"):
        TC.solve_dirac(U, b, KAPPA, EO_MIXED_SOLVER,
                       mesh=lattice_mesh(LATTICE[3], 4, devices=("cpu",)))
    with pytest.raises(ValueError, match="its shard on meta"):
        TMC.ShardedWilsonEO.from_slabs(
            U, KAPPA, LatticeMesh((torch.device("cpu"),
                                   torch.device("meta"))))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_slab_reference_equals_the_whole_reference(n):
    """M on slabs equals ``wilson.py``'s M on the whole field to 1e-12
    (complex128), and the two CGNEs need the same normal operators."""
    U, b = _fields(n)
    whole = wilson.WilsonEO(_whole(U, 4), KAPPA)
    op = wilson_slabs.SlabWilson(U, KAPPA)
    want = whole.matvec(_whole(b, 3))
    got = _whole(op.matvec(op.field(b)), 3)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    x, iters = wilson_slabs.solve(op, b, 1e-6, 1000)
    _, want_iters = wilson.solve(whole, _whole(b, 3), 1e-6, 1000)
    assert iters == want_iters
    assert wilson_slabs.true_residual(op, x, b) <= 1e-6


@pytest.mark.parametrize("make", [slabs.su3_field, slabs.spinor])
def test_row_generators_do_not_depend_on_the_slab_count(make):
    axis = 4 if make is slabs.su3_field else 3
    fields = [_whole(make(SEED, LATTICE, ["cpu"] * n), axis)
              for n in (1, 2, 4)]
    assert all(torch.equal(f, fields[0]) for f in fields[1:])
    assert not torch.equal(fields[0], _whole(
        make(SEED + 1, LATTICE, ["cpu"]), axis))


def test_the_slab_control_fails_its_limit():
    """The four-card configuration's control (the slab reference's CGNE
    through bfloat16) at the tiny size, on two CPU places: its answer's
    true residual stays above the configuration's ``residual_max``."""
    cfg = load_json(CONFIG)
    cfg.update({"lattice": list(LATTICE), "mesh": {"shards": 2}})
    drv = lqcd_slabs.Driver(cfg, {"warmup_items": 0}, SEED, ["cpu"] * 2)
    drv.use_control()
    drv.U = slabs.su3_field(SEED, LATTICE, drv.devices)
    count, x = drv.item(0)
    assert count["normal_ops"] == SolverConfig(**cfg["solver"]).max_iters
    (value, limit), = drv.check({0: x}).values()
    assert limit == 1e-6 and value > 1e3 * limit


CELL = "lqcd-cold-4chip"


class SteadyPower:
    """The power sampler's place on the CPU: 100 W on one board."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def window(self, t0, t1):
        return 100.0, 1500.0, 10, [{"board": "cpu", "watts": 100.0,
                                    "sm_clock_mhz": 1500.0, "samples": 10}]


@pytest.mark.parametrize("trace", [False, True])
def test_the_four_card_cell_runs_at_its_tiny_size(trace):
    """``lqcd-cold-4chip`` through the harness's ``execute`` at its tiny
    size over four CPU places: every kept answer correct, and the metrics
    that read program spans and counters reported (the device's have no
    trace to read on the CPU).  At this file's kappa a solve takes ~20
    normal operators, not the configuration's ~400, which the CPU's
    profiler would take minutes over."""
    from lcsc_bench.run import execute
    cell = spec.cell(CELL, trace)
    assert cell.chips == 4 and cell.config["mesh"]["shards"] == 4
    cell.config.update(cell.tiny, kappa=KAPPA)
    out = execute(cell, 2 ** 33 + 29, 0.5, trace, devices=["cpu"] * 4,
                  power=SteadyPower, t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4
    want = ({"solve.normal_ops", "solve.host_syncs", "device_idle.solve.halo",
             "device_idle.solve.reduce"} if trace else
            {"solve_ms", "solve_ms_p95", "gflops_per_w", "setup_s"})
    assert want <= set(out["metrics"])
    if trace:
        syncs = out["metrics"]["solve.host_syncs"]["value"]
        ops = out["metrics"]["solve.normal_ops"]["value"]
        assert syncs >= ops


def _trace_rec(counters, ops, busy_by_card, spans=None, shards=4):
    return {"config": {"lattice": [8, 8, 8, 16], "dtype": "float32",
                       "solver": {"inner_dtype": "bfloat16"},
                       "mesh": {"shards": shards}},
            "trace": {"window_s": 2.0, "busy_s": 1.5, "counters": counters,
                      "ops": ops, "busy_s_by_card": busy_by_card,
                      "spans": {"spans": spans or {}}}}


@pytest.mark.parametrize("launches, want", [(4 * (4 * 10 + 4 * 2 + 2), True),
                                            (4 * 10 + 4 * 2 + 2, False),
                                            (0, False)])
def test_the_four_card_roofline_counts_a_launch_a_shard(launches, want):
    """``dslash_eo_roofline.4chip``: the whole lattice's hop bytes over B1's
    seconds summed over the cards, read only where B1's launches are the
    shards times the hops the counters give."""
    from lcsc_bench.lib import counts
    from lcsc_bench.lib.peaks import HBM_BW
    rec = _trace_rec([{"inner": 10, "outer": 2}],
                     {"void dslash_eo_kernel<float>": [0.004, launches]}, {})
    got = spec.reader("dslash_eo_roofline.4chip").read(rec)
    if not want:
        assert got is None
        return
    volume = 8 * 8 * 8 * 16
    nbytes = (40 * counts.hop_bytes(volume, "bfloat16")
              + 10 * counts.hop_bytes(volume, "float32"))
    assert got == pytest.approx(100.0 * nbytes / HBM_BW / 0.004)


def test_the_four_card_device_readers():
    """``solve.card_busy_min`` takes the least busy card, a card with no
    activity at 0; ``device_idle.solve.halo`` and ``.reduce`` read their
    spans' idle over the stretch, and nothing where the span is absent."""
    busy = spec.reader("solve.card_busy_min").read
    halo = spec.reader("device_idle.solve.halo").read
    red = spec.reader("device_idle.solve.reduce").read
    rec = _trace_rec([], {}, {0: 1.8, 1: 1.6, 2: 1.7, 3: 1.9},
                     {"lqcd.halo": {"count": 3, "idle_total_s": 0.1}})
    assert busy(rec) == pytest.approx(80.0)
    assert halo(rec) == pytest.approx(5.0)
    assert red(rec) is None
    rec["trace"]["busy_s_by_card"] = {0: 1.8, 2: 1.7, 3: 1.9}
    assert busy(rec) == 0.0
    rec["trace"]["busy_s_by_card"] = {}
    assert busy(rec) is None
    assert all(r({"trace": None}) is None for r in (busy, halo, red))


@pytest.mark.parametrize("widen", [False, True])
def test_widened_pipe_takes_what_the_sampler_writes_before_it_reads(widen):
    """A child that writes 300 kB to a pipe nobody reads blocks at the
    pipe's 64 KiB; ``sampler_pipe.widen`` gives its pipe room for it all,
    and every byte is still read after."""
    code = ("import sys, time; time.sleep(0.5); "
            "sys.stdout.write('x' * 300000); sys.stdout.flush()")
    child = subprocess.Popen([sys.executable, "-c", code],
                             stdout=subprocess.PIPE, text=True)
    try:
        if widen:
            sizes = sampler_pipe.widen(os.path.basename(sys.executable))
            assert sizes and min(sizes) >= 1 << 19
        try:
            child.wait(timeout=5)
            ended = True
        except subprocess.TimeoutExpired:
            ended = False
        assert ended == widen
        assert len(child.communicate(timeout=30)[0]) == 300000
    finally:
        child.kill()
        child.wait()
