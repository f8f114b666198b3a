"""The port's energy core (``repro_torch.core.energy``, the chip table in
``repro_torch.power.model``, the LQCD calibration and ``linpack_run``'s
energy plan) against the JAX package's on the same inputs.

The DVFS planner, the throttle and the chip power law take the chip as a
table in the port; fed a table built from the JAX package's TPU constants
(``repro.power.model.TPU_*``, ``repro.roofline.hw``) they must give the
JAX package's numbers.  All comparisons are of the same numpy arithmetic
and hold at rel = 1e-12.
"""
import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.config import EnergyConfig as JEnergyConfig  # noqa: E402
from repro.core.energy import dvfs as JD  # noqa: E402
from repro.core.energy import throttle as JTh  # noqa: E402
from repro.lqcd import multichip_eo as JMC  # noqa: E402
from repro.power import model as JM  # noqa: E402
from repro.power.trace import TraceRecorder as JRecorder  # noqa: E402
from repro.roofline import hw as jhw  # noqa: E402
from repro_torch.config import EnergyConfig  # noqa: E402
from repro_torch.configs.hpl import SMOKE_HPL, HPLConfig  # noqa: E402
from repro_torch.core.energy import dvfs as TD  # noqa: E402
from repro_torch.core.energy import throttle as TTh  # noqa: E402
from repro_torch.hpl import linpack_run  # noqa: E402
from repro_torch.lqcd import multichip_eo as TMC  # noqa: E402
from repro_torch.lqcd.dirac import (dslash_bytes_per_site,  # noqa: E402
                                    dslash_flops_per_site)
from repro_torch.power import model as TM  # noqa: E402
from repro_torch.power.trace import TraceRecorder  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402

# (both packages re-export the solver_energy *function* under the module's
# name, so fetch the modules explicitly)
JS = importlib.import_module("repro.core.energy.solver_energy")
TS = importlib.import_module("repro_torch.core.energy.solver_energy")

REL = 1e-12

# The JAX package's TPU chip as a table of the port.  The planner reads no
# peak rate; the f32 slot holds the bf16 one, the only rate hw.py lists.
TPU_TABLE = TM.ChipTable(
    name="TPU v5e (the JAX package's constants)",
    idle_w=JM.TPU_IDLE_W, dyn_compute_w=JM.TPU_DYN_COMPUTE_W,
    dyn_mem_w=JM.TPU_DYN_MEM_W, power_limit_w=JM.TPU_TDP_W,
    peak_f32_flops=jhw.PEAK_BF16_FLOPS, peak_bf16_flops=jhw.PEAK_BF16_FLOPS,
    hbm_bw=jhw.HBM_BW)


def _close(got, want, rel=REL):
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float),
                               rtol=rel, atol=0.0)


# -- throttle curves ----------------------------------------------------------

@pytest.mark.parametrize("vid", [JM.V_MIN, 1.16, 1.18, JM.V_MAX])
@pytest.mark.parametrize("f", [500.0, 662.0, 774.0, 820.0, 900.0, 1000.0])
def test_throttle_curves_match_jax(f, vid):
    for temp in (40.0, 55.0, 75.0):
        _close(TTh.effective_frequency(f, vid, temp_c=temp),
               JTh.effective_frequency(f, vid, temp_c=temp))
        _close(TTh.dgemm_perf_gflops(f, vid, temp_c=temp),
               JTh.dgemm_perf_gflops(f, vid, temp_c=temp))
        for util in (0.85, JM.HPL_GPU_UTIL, 1.0):
            _close(TTh.hpl_node_perf(f, [vid, JM.V_MIN] * 2, temp_c=temp,
                                     util=util),
                   JTh.hpl_node_perf(f, [vid, JM.V_MIN] * 2, temp_c=temp,
                                     util=util))
    nodes = [[vid] * 4, [JM.V_MIN] * 4, [JM.V_MAX, vid, vid, JM.V_MIN]]
    _close(TTh.cluster_hpl_perf(f, nodes), JTh.cluster_hpl_perf(f, nodes))
    for name in ("OSC_PENALTY", "DGEMM_EFF", "HPL_NODE_SCALE"):
        assert getattr(TTh, name) == getattr(JTh, name)


@pytest.mark.parametrize("chip_eff", [0.8, 1.0])
@pytest.mark.parametrize("f", [0.3, 0.5, 0.75, 0.9, 1.0])
def test_chip_throttle_and_power_with_the_tpu_table_match_jax(f, chip_eff):
    for cu in (0.0, 0.3, 0.7, 1.0):
        for mu in (0.0, 0.4, 1.0):
            got = TTh.h100_sustained_scale(f, cu, mu, chip_eff=chip_eff,
                                           chip=TPU_TABLE)
            want = JTh.tpu_sustained_scale(f, cu, mu, chip_eff=chip_eff)
            assert got[1] == want[1]
            _close(got[0], want[0])
            _close(TM.h100_chip_power(f, cu, mu, TPU_TABLE),
                   JM.tpu_chip_power(f, cu, mu))
    for load in (0.0, 0.5, 1.0):
        got = TM.H100ChipModel(f, 0.7, 0.4, chip=TPU_TABLE)
        want = JM.TPUChipModel(f, 0.7, 0.4)
        a, b = got.component_watts(load=load), want.component_watts(load=load)
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k])
        _close(got.power(load=load), want.power(load=load))


# -- the DVFS planner ---------------------------------------------------------

ROOFLINES = [(0.2, 1.0, 0.1), (1.0, 0.2, 0.1), (1.0, 0.5, 0.1),
             (0.35, 0.16, 0.0), (1e-3, 2e-3, 0.0), (0.5, 0.5, 0.5),
             (2.0, 0.01, 0.3), (0.0, 1.0, 0.0)]


@pytest.mark.parametrize("chip_eff", [0.85, 1.0])
@pytest.mark.parametrize("mode,max_loss", [("efficiency", 0.015),
                                           ("efficiency", 0.10),
                                           ("performance", 0.015)])
@pytest.mark.parametrize("terms", ROOFLINES)
def test_plan_frequency_with_the_tpu_table_matches_jax(terms, mode, max_loss,
                                                       chip_eff):
    got = TD.plan_frequency(*terms, flops_per_step=1e12,
                            cfg=EnergyConfig(mode=mode,
                                             max_perf_loss=max_loss),
                            chip_eff=chip_eff, chip=TPU_TABLE)
    want = JD.plan_frequency(*terms, flops_per_step=1e12,
                             cfg=JEnergyConfig(mode=mode,
                                               max_perf_loss=max_loss),
                             chip_eff=chip_eff)
    assert (got.freq_scale, got.throttled, got.dominant) == \
        (want.freq_scale, want.throttled, want.dominant)
    _close([got.step_time_s, got.power_w, got.energy_per_step_j,
            got.perf_loss, got.efficiency_flops_per_w],
           [want.step_time_s, want.power_w, want.energy_per_step_j,
            want.perf_loss, want.efficiency_flops_per_w])


def test_energy_config_matches_jax():
    assert vars(EnergyConfig()) == vars(JEnergyConfig())


def test_heuristic_search_matches_jax():
    def objective(f, s):
        return f * (1.0 - 0.1 * s), 200.0 + f / 10.0 + 150.0 * s ** 3

    freqs, fans = [662.0, 774.0, 900.0], [0.2, 0.4, 0.6]
    assert TD.heuristic_search(objective, freqs, fans) == \
        JD.heuristic_search(objective, freqs, fans)


def test_plan_on_the_h100_table_stays_under_its_limit():
    plan = TD.plan_frequency(1.0, 0.2, 0.1, flops_per_step=1e12,
                             cfg=EnergyConfig(mode="performance"))
    assert plan.power_w <= TM.H100_SXM.power_limit_w
    assert plan.freq_scale >= 0.85 and not plan.throttled


# -- the solver energy model --------------------------------------------------

@pytest.mark.parametrize("eo,inner_bytes", [(False, 4), (True, 4),
                                            (True, 2)])
@pytest.mark.parametrize("volume,inner,outer", [(256, 19, 3), (4096, 100, 0),
                                                (32768, 57, 5),
                                                (262144, 1, 1)])
def test_solver_energy_matches_jax(volume, inner, outer, eo, inner_bytes):
    custom = dict(name="measured:1chip", bandwidth_gbs=812.5,
                  bw_fraction=1.0, power_w=301.25)
    for t_hw, j_hw in ((TS.S9150_HW, JS.S9150_HW),
                       (TS.SolverHW(**custom), JS.SolverHW(**custom))):
        got = TS.solver_energy("cg", volume, inner, outer_ops=outer,
                               inner_real_bytes=inner_bytes, even_odd=eo,
                               hw=t_hw)
        want = JS.solver_energy("cg", volume, inner, outer_ops=outer,
                                inner_real_bytes=inner_bytes, even_odd=eo,
                                hw=j_hw)
        assert got.normal_ops == want.normal_ops
        _close([got.bytes_total, got.time_s, got.energy_j, got.gflops,
                got.gflops_per_w, got.trace.energy_j()],
               [want.bytes_total, want.time_s, want.energy_j, want.gflops,
                want.gflops_per_w, want.trace.energy_j()])
        _close(TS.normal_op_bytes(volume, inner_bytes, even_odd=eo),
               JS.normal_op_bytes(volume, inner_bytes, even_odd=eo))


def test_solver_phases_stack_on_a_shared_bus_as_jax_does():
    rec_t, rec_j = TraceRecorder(), JRecorder()
    for ops in (10, 20):
        got = TS.solver_energy("a", 4096, ops, recorder=rec_t)
        want = JS.solver_energy("a", 4096, ops, recorder=rec_j)
    _close([got.energy_j, rec_t.t_last], [want.energy_j, rec_j.t_last])
    assert vars(TS.S9150_HW) == vars(JS.S9150_HW)


def test_h100_solver_hw_is_the_table():
    assert TS.H100_HW.bandwidth_gbs * 1e9 == TM.H100_SXM.hbm_bw == hw.HBM_BW
    assert TS.H100_HW.power_w == TM.H100_MEM_BOUND_W


# -- the H100 table -----------------------------------------------------------

def test_h100_table_constants_are_labelled():
    chip = TM.H100_SXM
    # data sheet: 67 TF/s f32, 989 TF/s bf16 dense, 3.35 TB/s, 80 GB, 700 W
    assert (chip.peak_f32_flops, chip.peak_bf16_flops, chip.hbm_bw) == \
        (67e12, 989e12, 3.35e12) == \
        (hw.PEAK_F32_FLOPS, hw.PEAK_BF16_FLOPS, hw.HBM_BW)
    assert hw.HBM_PER_CHIP == 80e9
    assert chip.power_limit_w == hw.POWER_LIMIT_W == 700.0
    # measured: the card's name and power limit as nvidia-smi prints them
    name, limit = TM.H100_MEASURED_ON.split(", ")
    assert name.startswith("NVIDIA H100") and limit.endswith(" W")
    assert float(limit[:-2]) > 0
    assert 0 < TM.H100_IDLE_W < TM.H100_MEM_BOUND_W
    assert TM.H100_IDLE_W < TM.H100_COMPUTE_BOUND_W
    assert max(TM.H100_MEM_BOUND_W, TM.H100_COMPUTE_BOUND_W) \
        <= 1.05 * float(limit[:-2])
    assert chip.idle_w == TM.H100_IDLE_W
    assert chip.idle_w + chip.dyn_mem_w == TM.H100_MEM_BOUND_W
    assert chip.idle_w + chip.dyn_compute_w == TM.H100_COMPUTE_BOUND_W
    assert TM.h100_chip_power(1.0, 1.0, 0.0) == TM.H100_COMPUTE_BOUND_W
    assert TM.h100_chip_power(1.0, 0.0, 1.0) == TM.H100_MEM_BOUND_W
    # the f^2 law below full clock
    assert TM.h100_chip_power(0.5, 1.0, 0.0) == pytest.approx(
        chip.idle_w + chip.dyn_compute_w / 4)


# -- the LQCD calibration -----------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 4])
@pytest.mark.parametrize("lattice", [(4, 4, 4, 4), (8, 8, 8, 16),
                                     (32, 32, 32, 8)])
def test_analytic_calibration_matches_jax(lattice, n_devices):
    for op in (None, "900"):
        t_op = None if op is None else TM.OperatingPoint(f_mhz=900.0)
        j_op = None if op is None else JM.OperatingPoint(f_mhz=900.0)
        got = TMC.analytic_lqcd_calibration(lattice, n_devices, t_op)
        want = JMC.analytic_lqcd_calibration(lattice, n_devices, j_op)
        assert (got.lattice, got.n_devices, got.source) == \
            (want.lattice, want.n_devices, want.source)
        _close([got.gflops, got.eff_bw_gbs, got.busy_w, got.wall_s,
                got.energy_j, got.gflops_per_w],
               [want.gflops, want.eff_bw_gbs, want.busy_w, want.wall_s,
                want.energy_j, want.gflops_per_w])


@pytest.mark.parametrize("reps", [1, 3])
def test_measured_calibration_on_the_cpu_is_consistent(reps):
    lattice = (4, 4, 4, 4)
    rec = TraceRecorder()
    rec.emit(0.0, {"gpu": 1.0})
    rec.emit(2.0, {"gpu": 1.0})
    cal = TMC.measured_lqcd_calibration(lattice, reps=reps, recorder=rec,
                                        device="cpu")
    volume = 4 ** 4
    assert (cal.lattice, cal.n_devices, cal.source) == (lattice, 1,
                                                        "measured")
    assert cal.wall_s > 0
    _close(cal.gflops,
           reps * 2 * volume * dslash_flops_per_site() / cal.wall_s / 1e9)
    _close(cal.eff_bw_gbs,
           reps * 2 * volume * dslash_bytes_per_site(4) / cal.wall_s / 1e9)
    # the card the rate is measured on: the table's HBM-bound watts
    assert cal.busy_w == TM.H100_MEM_BOUND_W
    # joules are the trace's integral over the run's own window, stacked
    # after the bus's earlier phase
    _close(cal.energy_j, cal.trace.energy_j(t0=2.0, t1=2.0 + cal.wall_s))
    _close(cal.energy_j, cal.busy_w * cal.wall_s)
    assert rec.t_last == pytest.approx(2.0 + cal.wall_s)
    _close(cal.gflops_per_w, cal.gflops / cal.busy_w)


def test_measured_calibration_refuses_a_mesh():
    """A mesh that is not a LatticeMesh (the sharded calibration itself is
    tested in tests/test_torch_multichip.py)."""
    with pytest.raises(TypeError, match="LatticeMesh"):
        TMC.measured_lqcd_calibration((4, 4, 4, 4), mesh=object(),
                                      device="cpu")


# -- linpack_run's energy plan ------------------------------------------------

@pytest.mark.parametrize("mode", ["efficiency", "performance"])
def test_linpack_energy_plan_and_trace(mode):
    cfg = HPLConfig(n=256, block=64)
    rec = TraceRecorder()
    rec.emit(0.0, {"chip": 5.0})
    rec.emit(1.0, {"chip": 5.0})
    res = linpack_run(cfg, energy=EnergyConfig(mode=mode), recorder=rec,
                      device="cpu")
    assert res.passed
    chip = TM.H100_SXM
    steps = cfg.n // cfg.block
    want = TD.plan_frequency(res.useful_flops / chip.peak_f32_flops,
                             cfg.n ** 2 * 4 * steps / chip.hbm_bw, 0.0,
                             flops_per_step=res.useful_flops,
                             cfg=EnergyConfig(mode=mode))
    assert res.energy_plan == {
        "freq_scale": want.freq_scale, "power_w": want.power_w,
        "energy_per_run_j": want.energy_per_step_j,
        "perf_loss": want.perf_loss, "dominant": want.dominant}
    tr = res.power_trace
    assert float(tr.t[-1]) == pytest.approx(1.0 + res.wall_s)
    _close(tr.energy_j(t0=1.0, t1=1.0 + res.wall_s),
           want.power_w * res.wall_s)
    _close(tr.total_flops(1.0, 1.0 + res.wall_s), res.useful_flops / 1e9)


def test_linpack_plan_at_full_size_is_compute_bound():
    """At n = 32768, nb = 256 the f32 GEMM work outweighs the matrix's
    streaming on the table's rates (0.35 s against 0.16 s)."""
    n, nb = 32768, 256
    compute_s = 2.0 / 3.0 * n ** 3 / TM.H100_SXM.peak_f32_flops
    memory_s = n * n * 4 * (n // nb) / TM.H100_SXM.hbm_bw
    plan = TD.plan_frequency(compute_s, memory_s, 0.0,
                             cfg=EnergyConfig(mode="performance"))
    assert plan.dominant == "compute" and not plan.throttled


def test_linpack_without_energy_records_nothing():
    rec = TraceRecorder()
    res = linpack_run(SMOKE_HPL, recorder=rec, device="cpu")
    assert res.energy_plan is None and res.power_trace is None
    assert len(rec) == 0
