"""The port's power engine (``repro_torch.power``) against the JAX
package's (``repro.power``) on the same inputs: the telemetry trace and
recorder, the S9150 device and layer models, the Green500 methodology,
``simulate`` and the published Green500 oracle.

Both packages run the same numpy arithmetic, so every comparison holds at
rel = 1e-12 (most are bit-equal); the oracle keeps ``tests/test_energy.py``'s
1.2 %, the paper's own measurement error.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import lcsc_lqcd as JC  # noqa: E402
from repro.power import engine as JE  # noqa: E402
from repro.power import green500 as JG  # noqa: E402
from repro.power import layers as JL  # noqa: E402
from repro.power import model as JM  # noqa: E402
from repro.power import trace as JT  # noqa: E402
from repro_torch.configs import lcsc_lqcd as TC  # noqa: E402
from repro_torch.core.energy.throttle import hpl_node_perf  # noqa: E402
from repro_torch.power import engine as TE  # noqa: E402
from repro_torch.power import green500 as TG  # noqa: E402
from repro_torch.power import layers as TL  # noqa: E402
from repro_torch.power import model as TM  # noqa: E402
from repro_torch.power import trace as TT  # noqa: E402

REL = 1e-12


def _close(got, want, rel=REL):
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float),
                               rtol=rel, atol=0.0)


def _op(M, f_mhz=774.0, vid=None, fan=0.40, nb=None, **kw):
    return M.OperatingPoint(f_mhz=f_mhz, vid=JM.V_MIN if vid is None else vid,
                            fan=fan,
                            nb=JM.NB_EFFICIENCY if nb is None else nb, **kw)


# -- the trace and the recorder ----------------------------------------------

def _emissions(mod, dt_s):
    """One seeded mix of scalar, series and interval emissions, out of
    order, with a late component and aux series."""
    rng = np.random.default_rng(11)
    rec = mod.TraceRecorder(dt_s=dt_s, source="parity")
    for t in (0.0, 1.5, 3.0):
        rec.emit(t, {"gpu": 250.0 + t, "host": 130.0},
                 flops_rate=100.0 * t, util=0.9)
    rec.emit(4.25, {"gpu": 240.0, "network": 257.0}, flops_rate=80.0,
             f_mhz=774.0)
    ts = np.linspace(5.0, 20.0, 31)
    rec.emit_series(ts, {"gpu": rng.uniform(100, 300, ts.size),
                         "fan": 20.0},
                    flops_rate=rng.uniform(0, 500, ts.size), util=0.5)
    rec.emit_intervals(np.array([21.0, 24.0, 24.0, 30.0]),
                       {"gpu": np.array([100.0, 200.0, 150.0, 50.0]),
                        "host": 137.8},
                       span=33.3, dt_s=0.7, flops_rate=np.array(
                           [1.0, 2.0, 3.0, 4.0]), util=0.25)
    rec.emit(2.0, {"gpu": 99.0}, flops_rate=5.0)       # out of order
    return rec


@pytest.mark.parametrize("dt_s", [None, 0.5, 2.0])
def test_recorder_trace_matches_jax(dt_s):
    got, want = _emissions(TT, dt_s), _emissions(JT, dt_s)
    assert len(got) == len(want) and got.t_last == want.t_last
    a, b = got.trace(), want.trace()
    _close(a.t, b.t)
    assert sorted(a.components) == sorted(b.components)
    for k in a.components:
        _close(a.components[k], b.components[k])
    assert sorted(a.aux) == sorted(b.aux)
    for k in a.aux:
        _close(a.aux[k], b.aux[k])
    _close(a.flops_rate, b.flops_rate)
    assert a.meta == b.meta


@pytest.mark.parametrize("window", [(None, None), (0.3, 17.9), (4.25, 33.3),
                                    (21.1, 21.2)])
@pytest.mark.parametrize("dt_s", [None, 0.5])
def test_trace_integrals_match_jax(dt_s, window):
    a, b = _emissions(TT, dt_s).trace(), _emissions(JT, dt_s).trace()
    t0, t1 = window
    for net in (True, False):
        _close(a.energy_j(t0, t1, include_network=net),
               b.energy_j(t0, t1, include_network=net))
        _close(a.avg_power(t0, t1, include_network=net),
               b.avg_power(t0, t1, include_network=net))
    _close(a.total_flops(t0, t1), b.total_flops(t0, t1))
    ea, eb = a.component_energy_j(), b.component_energy_j()
    assert sorted(ea) == sorted(eb)
    for k in ea:
        _close(ea[k], eb[k])
    _close(a.power_w, b.power_w)
    _close(a.network_w, b.network_w)
    _close(a.scaled(3.5).energy_j(), b.scaled(3.5).energy_j())


def test_trace_from_arrays_matches_jax():
    t = np.linspace(0, 60, 13)
    p = 1000 + 10 * np.sin(t)
    a = TT.PowerTrace.from_arrays(t, p, p / 2, network_w=257.0)
    b = JT.PowerTrace.from_arrays(t, p, p / 2, network_w=257.0)
    _close(a.energy_j(), b.energy_j())
    _close(a.avg_power(include_network=False),
           b.avg_power(include_network=False))
    with pytest.raises(ValueError, match="no samples"):
        TT.TraceRecorder().trace()


def test_trapezoid_bridge_matches_numpy():
    y, x = np.array([1.0, 3.0, 2.0, 5.0]), np.array([0.0, 0.5, 2.0, 2.5])
    assert TT.trapezoid(y, x) == pytest.approx(
        float(np.sum((y[1:] + y[:-1]) / 2 * np.diff(x))), rel=REL)


# -- the S9150 device model ---------------------------------------------------

FREQS = [300.0, 457.0, 662.0, 774.0, 820.0, 900.0, 1000.0]
VIDS = [JM.V_MIN, 1.16, 1.175, JM.V_MAX]
TEMPS = [40.0, 55.0, 70.0, 90.0]
FANS = [0.0, 0.15, 0.3, 0.4, 0.6, 1.0]
UTILS = [0.0, 0.5, JM.HPL_GPU_UTIL, 1.0]


@pytest.mark.parametrize("name", [
    "STOCK_MHZ", "EFFICIENT_MHZ", "V_MIN", "V_MAX", "P_GPU_STATIC_40C",
    "TEMP_SLOPE_W_PER_C", "K_DYN", "FAN_BASE_W", "FAN_CUBIC_W",
    "V_F_SLOPE", "NB_EFFICIENCY", "NB_PERFORMANCE", "HPL_GPU_UTIL"])
def test_s9150_constants_match_jax(name):
    assert getattr(TM, name) == getattr(JM, name)


def test_s9150_specs_match_jax():
    assert vars(TM.S9150) == vars(JM.S9150)
    assert vars(TM.S10000_CHIP) == vars(JM.S10000_CHIP)
    for f in (0.3, 0.774, 0.9):
        assert TM.S9150.peak_fp64_gflops(f) == JM.S9150.peak_fp64_gflops(f)


@pytest.mark.parametrize("vid", VIDS)
@pytest.mark.parametrize("f", FREQS)
def test_gpu_power_curves_match_jax(f, vid):
    _close(TM.voltage_at(f, vid), JM.voltage_at(f, vid))
    for temp in TEMPS:
        _close(TM.gpu_static_power(vid, temp), JM.gpu_static_power(vid, temp))
        for util in UTILS:
            _close(TM.gpu_power(f, vid, temp_c=temp, util=util),
                   JM.gpu_power(f, vid, temp_c=temp, util=util))
            assert TM.sustained_frequency(f, vid, temp_c=temp, util=util) \
                == pytest.approx(JM.sustained_frequency(
                    f, vid, temp_c=temp, util=util), rel=REL)
            _close(TM.gpu_power_throttled(f, vid, temp_c=temp, util=util),
                   JM.gpu_power_throttled(f, vid, temp_c=temp, util=util))
    # the array forms
    _close(TM.voltage_at(np.array(FREQS), vid),
           JM.voltage_at(np.array(FREQS), vid))
    _close(TM.gpu_power_throttled(f, vid, util=np.array(UTILS)),
           JM.gpu_power_throttled(f, vid, util=np.array(UTILS)))


@pytest.mark.parametrize("fan", FANS)
def test_fan_and_blocking_curves_match_jax(fan):
    _close(TM.fan_power(fan), JM.fan_power(fan))
    _close(TM.fan_curve(fan), JM.fan_curve(fan))
    _close(TM.temp_from_fan(fan), JM.temp_from_fan(fan))
    _close(TM.fan_power(np.array(FANS)), JM.fan_power(np.array(FANS)))
    _close(TM.fan_curve(np.array(FANS)), JM.fan_curve(np.array(FANS)))
    for nb in (64, 128, 256, 384, 512, 1024, 2048):
        _close(TM.hpl_block_util(nb), JM.hpl_block_util(nb))
        _close(TM.hpl_block_perf_scale(nb), JM.hpl_block_perf_scale(nb))
    for depth in (0, 1, 2):
        assert TM.lookahead_perf_scale(depth) == \
            JM.lookahead_perf_scale(depth)


def test_operating_point_matches_jax():
    a, b = TM.OperatingPoint.green500(), JM.OperatingPoint.green500()
    assert vars(a) == vars(b)
    assert a.temperature() == b.temperature()
    assert a.gpu_util() == b.gpu_util()
    point = {"f_mhz": 851, "vid": 1.17, "fan": 0.35, "nb": 384,
             "lookahead": 0}
    assert vars(TM.OperatingPoint.from_point(point)) == \
        vars(JM.OperatingPoint.from_point(point))
    rng = np.random.default_rng(3)
    _close(TM.sample_vids(rng, 64),
           JM.sample_vids(np.random.default_rng(3), 64))


# -- the layers ---------------------------------------------------------------

@pytest.mark.parametrize("f,vid,fan,nb", [
    (774.0, JM.V_MIN, 0.40, 512), (900.0, JM.V_MIN, 0.40, 1024),
    (900.0, JM.V_MAX, 0.60, 512), (662.0, 1.17, 0.25, 256),
    (457.0, JM.V_MAX, 0.15, 128)])
def test_layers_match_jax(f, vid, fan, nb):
    op_t, op_j = _op(TM, f, vid, fan, nb), _op(JM, f, vid, fan, nb)
    vids = (JM.V_MIN, 1.16, 1.18, JM.V_MAX)
    for load in (0.0, 0.35, 1.0):
        a = TL.NodeModel.from_vids(vids).component_watts(op_t, load=load)
        b = JL.NodeModel.from_vids(vids).component_watts(op_j, load=load)
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k])
    loads, fans = np.linspace(0, 1, 9), np.linspace(0.15, 0.4, 9)
    a = TL.lcsc_cluster(16).component_watts_series(op_t, load=loads,
                                                   fan=fans)
    b = JL.lcsc_cluster(16).component_watts_series(op_j, load=loads,
                                                   fan=fans)
    for k in b:
        _close(a[k], b[k])
    _close(TL.lcsc_cluster().power(op_t), JL.lcsc_cluster().power(op_j))
    for dc in (50.0, 500.0, 958.0, 1800.0):
        _close(TL.LCSC_PSU.loss_w(dc), JL.LCSC_PSU.loss_w(dc))
    _close(TL.node_power(f, vids, fan=fan, temp_c=60.0, util=0.9),
           JL.node_power(f, vids, fan=fan, temp_c=60.0, util=0.9))
    counts = np.array([0, 1, 4, 2, 3])
    a = TL.lcsc_node().component_watts_batch(op_t, counts)
    b = JL.lcsc_node().component_watts_batch(op_j, counts)
    for k in b:
        _close(a[k], b[k])


def test_published_node_and_cluster_watts():
    """~1021 W per node and 57.2 kW for the 56-node Green500 cluster
    (``tests/test_power_engine.py``'s 2 %)."""
    op = TM.OperatingPoint.green500()
    node = TL.lcsc_node().power(op)
    assert abs(node - 1021.0) / 1021.0 < 0.02
    cl = TL.lcsc_cluster()
    assert cl.n_nodes == TC.GREEN500_NODES
    assert cl.network_w == TC.GREEN500_SWITCH_POWER_W
    assert abs(cl.power(op) - cl.network_w - 57.2e3) / 57.2e3 < 0.02


# -- Green500 methodology -----------------------------------------------------

def _linpack_trace(mod):
    return mod.linpack_power_trace(56, 1021.0, 5384.0, duration_s=1800.0)


@pytest.mark.parametrize("level", [1, 2, 3])
def test_measure_efficiency_matches_jax(level):
    a = TG.measure_efficiency(_linpack_trace(TG), level)
    b = JG.measure_efficiency(_linpack_trace(JG), level)
    assert (a.level, a.measured_fraction, a.notes) == \
        (b.level, b.measured_fraction, b.notes)
    _close(a.window, b.window)
    _close([a.avg_power_w, a.perf_gflops, a.mflops_per_w],
           [b.avg_power_w, b.perf_gflops, b.mflops_per_w])
    sa = TE.simulate(TE.SyntheticHPL(900.0), TM.OperatingPoint.green500(),
                     cluster=TL.lcsc_cluster(8))
    sb = JE.simulate(JE.SyntheticHPL(900.0), JM.OperatingPoint.green500(),
                     cluster=JL.lcsc_cluster(8))
    a, b = TG.measure_efficiency(sa, level), JG.measure_efficiency(sb, level)
    _close([a.avg_power_w, a.perf_gflops, a.mflops_per_w],
           [b.avg_power_w, b.perf_gflops, b.mflops_per_w])


def test_level1_exploit_and_variability_match_jax():
    a = TG.level1_exploit(_linpack_trace(TG))
    b = JG.level1_exploit(_linpack_trace(JG))
    _close([a.mflops_per_w, a.avg_power_w, *a.window],
           [b.mflops_per_w, b.avg_power_w, *b.window])
    l3 = TG.measure_efficiency(_linpack_trace(TG), 3)
    assert 0.10 < a.mflops_per_w / l3.mflops_per_w - 1 < 0.45
    effs_t = TG.node_efficiencies(np.random.default_rng(0), 7)
    effs_j = JG.node_efficiencies(np.random.default_rng(0), 7)
    _close(effs_t, effs_j)
    assert TG.select_median_nodes(effs_t) == JG.select_median_nodes(effs_j)
    _close(TG.extrapolation_error(effs_t), JG.extrapolation_error(effs_j))
    with pytest.raises(ValueError, match="outside the middle 80%"):
        TG.measure_efficiency(_linpack_trace(TG), 1, window=(0.0, 400.0))


# -- the engine -------------------------------------------------------------

def _profiles(mod, model, green500):
    replay_src = green500.linpack_power_trace(1, 1000.0, 5000.0,
                                              duration_s=300.0)
    replay_src.aux["util"] = np.linspace(1.0, 0.2, replay_src.t.size)
    return {"synthetic": mod.SyntheticHPL(1200.0),
            "constant": mod.ConstantLoad(400.0, level=0.7),
            "replay": mod.ReplayWorkload.from_trace(replay_src)}


@pytest.mark.parametrize("adaptive_fan", [True, False])
@pytest.mark.parametrize("profile", ["synthetic", "constant", "replay"])
@pytest.mark.parametrize("f_mhz", [774.0, 900.0])
def test_simulate_matches_jax_sample_by_sample(profile, f_mhz, adaptive_fan):
    a = TE.simulate(_profiles(TE, TM, TG)[profile], _op(TM, f_mhz),
                    cluster=TL.lcsc_cluster(12, nodes_per_rack=4),
                    dt_s=7.0, adaptive_fan=adaptive_fan)
    b = JE.simulate(_profiles(JE, JM, JG)[profile], _op(JM, f_mhz),
                    cluster=JL.lcsc_cluster(12, nodes_per_rack=4),
                    dt_s=7.0, adaptive_fan=adaptive_fan)
    _close(a.t, b.t)
    assert sorted(a.components) == sorted(b.components)
    for k in a.components:
        _close(a.components[k], b.components[k])
    for k in b.aux:
        _close(a.aux[k], b.aux[k])
    _close(a.flops_rate, b.flops_rate)
    assert a.meta == b.meta


def test_simulate_stacks_on_a_shared_bus_as_jax_does():
    rec_t, rec_j = TT.TraceRecorder(dt_s=5.0), JT.TraceRecorder(dt_s=5.0)
    for _ in range(2):
        a = TE.simulate(TE.ConstantLoad(60.0), recorder=rec_t,
                        cluster=TL.lcsc_cluster(2))
        b = JE.simulate(JE.ConstantLoad(60.0), recorder=rec_j,
                        cluster=JL.lcsc_cluster(2))
    _close(a.t, b.t)
    _close(a.energy_j(), b.energy_j())
    # the second run starts at the first's last sample (t = 60)
    assert rec_t.t_last == rec_j.t_last == 120.0


@pytest.mark.parametrize("f_mhz", [662.0, 774.0, 900.0])
def test_node_perf_and_evaluation_match_jax(f_mhz):
    _close(TE.node_hpl_gflops(_op(TM, f_mhz)), JE.node_hpl_gflops(
        _op(JM, f_mhz)))
    _close(TE.evaluate_operating_point(_op(TM, f_mhz)),
           JE.evaluate_operating_point(_op(JM, f_mhz)))


# -- the published oracle ----------------------------------------------------

def test_green500_oracle():
    """56 nodes, 301.5 TFLOPS at 57.2 kW: 5271.8 MFLOPS/W, within the
    paper's 1.2 % (``tests/test_energy.py::test_green500_headline_result``),
    through the port's copies of the curves and layers."""
    perf = hpl_node_perf(774, [TM.V_MIN] * 4)
    pw = [TM.gpu_power_throttled(774, TM.V_MIN, util=TM.HPL_GPU_UTIL)] * 4
    p_node = TL.node_power(774, [TM.V_MIN] * 4, gpu_clamped_w=pw)
    assert abs(perf * 56 - TC.GREEN500_LINPACK_TFLOPS * 1e3) \
        / (TC.GREEN500_LINPACK_TFLOPS * 1e3) < 0.012
    assert abs(p_node * 56 - TC.GREEN500_AVG_POWER_KW * 1e3) \
        / (TC.GREEN500_AVG_POWER_KW * 1e3) < 0.012
    eff = perf / p_node * 1000
    assert abs(eff - TC.GREEN500_EFFICIENCY_MFLOPS_W) \
        / TC.GREEN500_EFFICIENCY_MFLOPS_W < 0.012
    # one node through the engine's query surface
    # (``tests/test_power_engine.py``'s 2 %)
    perf, power = TE.evaluate_operating_point(TM.OperatingPoint.green500())
    assert abs(perf / power * 1000.0 - 5271.8) / 5271.8 < 0.02


def test_published_constants_match_jax():
    names = [n for n in vars(JC) if n.isupper()]
    assert len(names) > 30
    for n in names:
        got, want = getattr(TC, n), getattr(JC, n)
        if hasattr(want, "__dataclass_fields__"):
            got, want = repr(got), repr(want)
        assert got == want, n
    for node in ("LOEWE_CSC", "SANAM", "L_CSC"):
        assert vars(getattr(TC, node)) == vars(getattr(JC, node))
