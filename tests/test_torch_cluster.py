"""The port's Workload API, scheduler and ``run``
(``repro_torch.cluster``) against the JAX package's (``repro.cluster``):
``tests/test_cluster.py``'s scenarios through both packages — placements,
straggler pacing, power-cap derating, per-job operating points, merged
traces (the vectorized engine against its loop oracle), shared-bus
windowing — must give the same schedules and traces at rel = 1e-12.  The
adapters that run real code (HPL, the LQCD solve) run on the CPU here.
"""
import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.cluster as JCl  # noqa: E402
import repro.cluster.scheduler as JSch  # noqa: E402
import repro_torch.cluster as TCl  # noqa: E402
import repro_torch.cluster.scheduler as TSch  # noqa: E402
import repro_torch.cluster.workload as TW  # noqa: E402
from repro.autotune.measure import recommended_operating_point  # noqa: E402
from repro.autotune.space import S9150_DPM_STATES_MHZ  # noqa: E402
from repro.configs import lcsc_lqcd as JC  # noqa: E402
from repro.core.energy.solver_energy import solver_energy  # noqa: E402
from repro.core.energy.solver_energy import SolverHW as JSolverHW  # noqa: E402
from repro.lqcd import random_su3_field as jax_random_su3  # noqa: E402
from repro.power import engine as JE  # noqa: E402
from repro.power import model as JM  # noqa: E402
from repro.power.trace import TraceRecorder as JRecorder  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import lcsc_lqcd as TC  # noqa: E402
from repro_torch.configs.hpl import SMOKE_HPL, HPLConfig  # noqa: E402
from repro_torch.lqcd import analytic_lqcd_calibration  # noqa: E402
from repro_torch.power import engine as TE  # noqa: E402
from repro_torch.power import model as TM  # noqa: E402
from repro_torch.power.layers import NodeModel  # noqa: E402
from repro_torch.power.trace import PowerTrace, TraceRecorder  # noqa: E402

# (the packages re-export the ``run`` *function* under the module's name)
TRun = importlib.import_module("repro_torch.cluster.run")

REL = 1e-12


def _close(got, want, rel=REL):
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float),
                               rtol=rel, atol=0.0)


def _op(pkg, **kw):
    return (TM if pkg == "t" else JM).OperatingPoint(**kw)


def _jobs(pkg, spec):
    """Job specs from ``(name, mem_gb, work_units, kw)`` tuples, with
    ``preferred_op`` given as a dict of OperatingPoint fields."""
    mod = TSch if pkg == "t" else JSch
    out = []
    for name, mem, work, kw in spec:
        kw = dict(kw)
        if "preferred_op" in kw:
            kw["preferred_op"] = _op(pkg, **kw["preferred_op"])
        out.append(mod.Job(name, mem, work, **kw))
    return out


def _op_key(op):
    return None if op is None else tuple(sorted(vars(op).items()))


def _assert_same_schedule(a, b):
    assert len(a.placements) == len(b.placements)
    for p, q in zip(a.placements, b.placements):
        assert (p.job.name, p.chips, p.sharded, p.nodes, _op_key(p.op)) == \
            (q.job.name, q.chips, q.sharded, q.nodes, _op_key(q.op))
        _close([p.start, p.end, p.rate_per_chip],
               [q.start, q.end, q.rate_per_chip])
    assert _op_key(a.op) == _op_key(b.op)
    assert a.derated == b.derated
    _close(a.makespan, b.makespan)


def _assert_same_trace(a, b, rel=REL):
    _close(a.t, b.t, rel)
    assert sorted(a.components) == sorted(b.components)
    for k in a.components:
        _close(a.components[k], b.components[k], rel)
    _close(a.flops_rate, b.flops_rate, rel)
    assert sorted(a.aux) == sorted(b.aux)
    for k in a.aux:
        _close(a.aux[k], b.aux[k], rel)
    assert a.meta == b.meta


# -- scheduling scenarios (tests/test_cluster.py) -----------------------------

G500 = dict(f_mhz=774.0)
SCENARIOS = {
    "packed_thermal": (dict(n_nodes=2), "packed", None,
                       [(f"lat{i}", 13.0, 1.0, {}) for i in range(8)]),
    "packed_cold_shard": (dict(n_nodes=2), "packed", None,
                          [("cold", 30.0, 1.0, {})]),
    "round_robin": (dict(n_nodes=2), "round_robin", None,
                    [(f"lat{i}", 13.0, 1.0, {}) for i in range(8)]),
    "straggler": (dict(n_nodes=1, perf_scales=(1.0, 0.5, 1.0, 1.0)),
                  "packed", None, [("cold", 32.0, 1.0, {})]),
    "queued_mixed": (dict(n_nodes=3), "packed", None,
                     [(f"j{i}", 13.0 if i % 3 else 29.0,
                       float(50 + 37 * i % 650), {}) for i in range(40)]),
    "mixed_preferences": (dict(n_nodes=1), "packed", None, [
        ("hpl", 13.0, 1.0, {"preferred_op": dict(f_mhz=900.0)}),
        ("lqcd", 13.0, 1.0, {"preferred_op": G500}),
        ("serve", 13.0, 1.0, {"preferred_op": dict(f_mhz=655.0)})]),
    "power_cap_per_job": (dict(n_nodes=1), "packed", 1400.0, [
        ("hot", 13.0, 1.0, {"preferred_op": dict(f_mhz=900.0)}),
        ("cool", 13.0, 1.0, {"preferred_op": G500})]),
    "power_cap_cluster": (dict(n_nodes=56), "packed", 50e3,
                          [(f"lat{i}", 13.0, 600.0, {}) for i in range(30)]),
    "compute_kinds": (dict(n_nodes=2), "packed", None, [
        ("hpl", 52.0, 1800.0, {"kind": "hpl",
                               "preferred_op": dict(f_mhz=900.0)}),
        ("lqcd", 4.1, 2.0, {"kind": "lqcd", "preferred_op": G500}),
        ("gen", 13.0, 300.0, {"preferred_op": dict(f_mhz=851.0)})]),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_schedule_matches_jax(scenario):
    top, policy, cap, spec = SCENARIOS[scenario]
    a = TSch.Scheduler(TSch.ClusterTopology(**top), policy=policy,
                       power_cap_w=cap).schedule(_jobs("t", spec))
    b = JSch.Scheduler(JSch.ClusterTopology(**top), policy=policy,
                       power_cap_w=cap).schedule(_jobs("j", spec))
    _assert_same_schedule(a, b)


@pytest.mark.parametrize("dt_s", [7.0, 60.0])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_merged_trace_matches_jax_and_its_loop_oracle(scenario, dt_s):
    top, policy, cap, spec = SCENARIOS[scenario]
    a = TCl.run(_jobs("t", spec), topology=TSch.ClusterTopology(**top),
                policy=policy, power_cap_w=cap, dt_s=dt_s)
    b = JCl.run(_jobs("j", spec), topology=JSch.ClusterTopology(**top),
                policy=policy, power_cap_w=cap, dt_s=dt_s)
    _assert_same_schedule(a.schedule, b.schedule)
    _assert_same_trace(a.trace, b.trace)
    # the vectorized engine against the port's own per-tick loop oracle,
    # bit for bit
    oracle = TRun._merged_trace_reference(
        a.schedule, dt_s=dt_s, network_w=a.schedule.topology.network_w)
    vec = TRun._merged_trace(a.schedule, dt_s=dt_s,
                             network_w=a.schedule.topology.network_w)
    _assert_same_trace(vec, oracle, rel=0.0)
    for level in (1, 2, 3) if a.trace.t.size > 12 else (2, 3):
        x, y = a.efficiency(level), b.efficiency(level)
        _close([x.avg_power_w, x.perf_gflops, x.mflops_per_w],
               [y.avg_power_w, y.perf_gflops, y.mflops_per_w])


def test_merged_trace_composes_node_layers():
    top = TSch.ClusterTopology(n_nodes=4)
    jobs = [TSch.Job(f"lat{i}", 13.0, 600.0) for i in range(top.n_chips)]
    res = TCl.run(jobs, topology=top, op=TM.OperatingPoint.green500(),
                  dt_s=60.0)
    for comp in ("gpu", "host", "fan", "psu_loss", "network"):
        assert comp in res.trace.components
    expect = NodeModel().power(TM.OperatingPoint.green500()) * top.n_nodes
    assert float(res.trace.power_w[0]) == pytest.approx(expect, rel=1e-9)
    assert res.efficiency(3).mflops_per_w > 4000


@pytest.mark.parametrize("cap,f_mhz", [(50e3, 774.0), (60e3, 774.0),
                                       (40e3, 900.0)])
def test_power_cap_derating_matches_jax(cap, f_mhz):
    a = TSch.Scheduler(TSch.ClusterTopology(n_nodes=56),
                       power_cap_w=cap).resolve_operating_point(
        _op("t", f_mhz=f_mhz))
    b = JSch.Scheduler(JSch.ClusterTopology(n_nodes=56),
                       power_cap_w=cap).resolve_operating_point(
        _op("j", f_mhz=f_mhz))
    assert (_op_key(a[0]), a[1]) == (_op_key(b[0]), b[1])


@pytest.mark.parametrize("op", [None, dict(f_mhz=200.0)])
def test_infeasible_power_cap_raises_as_jax_does(op):
    for mod, pkg in ((TSch, "t"), (JSch, "j")):
        with pytest.raises(mod.PowerCapError, match="infeasible"):
            mod.Scheduler(mod.ClusterTopology(n_nodes=56),
                          power_cap_w=1e3).resolve_operating_point(
                None if op is None else _op(pkg, **op))


def test_clean_scheduling_errors():
    with pytest.raises(TSch.SchedulingError, match="more than a node's total"):
        TSch.Scheduler(TSch.ClusterTopology(n_nodes=4)).schedule(
            [TSch.Job("huge", 100.0, 1.0)])
    with pytest.raises(TSch.SchedulingError, match="not .*shardable"):
        TSch.Scheduler().schedule([TSch.Job("pinned", 20.0, 1.0,
                                            shardable=False)])
    with pytest.raises(ValueError, match="unknown policy"):
        TSch.Scheduler(policy="steal")
    with pytest.raises(ValueError, match="empty workload batch"):
        TCl.run([])


def test_dpm_ladder_is_the_jax_autotuners():
    assert TSch.S9150_DPM_STATES_MHZ == S9150_DPM_STATES_MHZ


def test_recommended_op_is_the_jax_autotuners_pick():
    """The port has no autotuner: it takes the Green500 point, which the
    JAX package's coordinate-descent search rediscovers.  A drift of
    either shows here."""
    got = TSch.Scheduler()._recommended_op()
    assert got == TM.OperatingPoint.green500()
    assert _op_key(got) == _op_key(recommended_operating_point())
    assert _op_key(JSch.Scheduler()._recommended_op()) == _op_key(got)


@pytest.mark.parametrize("kind", ["hpl", "lqcd", "gen"])
@pytest.mark.parametrize("f_mhz", [662.0, 774.0, 900.0])
def test_op_rate_scale_matches_jax(kind, f_mhz):
    a = TSch.op_rate_scale(TSch.Job("j", 1.0, 1.0, kind=kind),
                           _op("t", f_mhz=f_mhz))
    b = JSch.op_rate_scale(JSch.Job("j", 1.0, 1.0, kind=kind),
                           _op("j", f_mhz=f_mhz))
    _close(a, b)


def test_legacy_flat_api_matches_jax():
    def placements(mod):
        chips = [mod.Chip(i, 16.0, perf_scale=1.0 - 0.05 * i)
                 for i in range(4)]
        jobs = [mod.Job(f"t{i}", 3.0 + 9 * (i % 2), 1.0 + i)
                for i in range(8)] + [mod.Job("cold", 48.0, 2.0)]
        return mod.schedule_throughput(jobs, chips)

    for p, q in zip(placements(TSch), placements(JSch), strict=True):
        assert (p.job.name, p.chips) == (q.job.name, q.chips)
        _close([p.start, p.end], [q.start, q.end])
    _close(TSch.straggler_step_time(1.0, [1.0, 0.8, 1.0]),
           JSch.straggler_step_time(1.0, [1.0, 0.8, 1.0]))
    _close(TSch.expected_slowdown(1000, 0.012),
           JSch.expected_slowdown(1000, 0.012))
    _close(TSch.frequency_floor_mitigation([1.0, 0.95, 0.9]),
           JSch.frequency_floor_mitigation([1.0, 0.95, 0.9]))
    pods = {"a": 1.0, "b": 1.0, "c": 0.5}
    assert TSch.drop_slowest_pod(pods) == JSch.drop_slowest_pod(pods)
    _close(TSch.synchronous_rate([1.0, 0.5]),
           JSch.synchronous_rate([1.0, 0.5]))
    top = TSch.ClusterTopology(n_nodes=1, perf_scales=(1.0, 0.9, 1.0, 1.0))
    assert set(TSch.with_perf_floor(top).perf_scales) == {0.9}


def test_chip_pool_matches_jax():
    picks = []
    for mod in (TSch, JSch):
        pool = mod.ChipPool(mod.ClusterTopology(n_nodes=3))
        got = [c.chip_id for c in pool.pick_now(2, 0.0)]
        for c in pool.chips[:5]:
            c.busy_until = 10.0 + c.chip_id
        pool.fail_node(2, 1.0, 50.0)
        got += [c.chip_id for c in pool.pick_now(1, 5.0)]
        chips, t = pool.earliest_pool(4)
        got += [c.chip_id for c in chips] + [t]
        pool.repair_node(2, 60.0)
        pool.release([0, 1], 2.0)
        got += [c.chip_id for c in pool.pick_now(3, 61.0)]
        picks.append(got)
    assert picks[0] == picks[1]


# -- the registry and the adapters --------------------------------------------

def test_registry_holds_the_ported_adapters():
    assert TCl.list_workloads() == ["hpl", "lqcd", "synthetic"]
    assert TCl.make_workload("synthetic").job().kind == "synthetic"
    with pytest.raises(KeyError, match="unknown workload"):
        TCl.make_workload("quantum")
    assert TCl.WORKLOAD_REGISTRY is not JCl.WORKLOAD_REGISTRY
    with pytest.raises(ValueError, match="already registered"):
        TCl.register_workload("hpl")(type("Again", (), {}))


@pytest.mark.parametrize("kind,where", [("train", "ROADMAP A6"),
                                        ("serve", "ROADMAP A6"),
                                        ("serve_replay", "ROADMAP A6")])
def test_unported_kinds_raise(kind, where):
    with pytest.raises(NotImplementedError, match=where):
        TCl.make_workload(kind)


@pytest.mark.parametrize("kind", ["hpl", "lqcd", "synthetic"])
def test_adapter_jobs_match_jax(kind):
    a, b = TCl.make_workload(kind).job(), JCl.make_workload(kind).job()
    assert (a.name, a.shardable, a.kind, _op_key(a.preferred_op)) == \
        (b.name, b.shardable, b.kind, _op_key(b.preferred_op))
    _close([a.mem_gb, a.work_units, a.state_bytes],
           [b.mem_gb, b.work_units, b.state_bytes])
    assert TCl.make_workload(kind).state_bytes() == \
        JCl.make_workload(kind).state_bytes()


def test_adapters_default_to_the_card():
    assert TW.HPLWorkload().device == TW.LQCDSolveWorkload().device == "cuda"


def test_lattice_mem_gb_matches_jax():
    for name in ("SMOKE_LATTICE", "THERMAL_LATTICE", "COLD_LATTICE"):
        _close(getattr(TC, name).mem_gb, getattr(JC, name).mem_gb)


@pytest.mark.parametrize("f_mhz", [774.0, 900.0])
def test_synthetic_workload_matches_jax(f_mhz):
    prof_t, prof_j = TE.SyntheticHPL(600.0), JE.SyntheticHPL(600.0)
    a = TW.SyntheticWorkload(profile=prof_t, n_nodes=3).execute(
        _op("t", f_mhz=f_mhz))
    b = JCl.SyntheticWorkload(profile=prof_j, n_nodes=3).execute(
        _op("j", f_mhz=f_mhz))
    _close([a.perf_gflops, a.wall_s, a.energy_j, a.gflops_per_w],
           [b.perf_gflops, b.wall_s, b.energy_j, b.gflops_per_w])
    _assert_same_trace(a.power_trace, b.power_trace)


def test_shared_bus_energy_is_windowed_per_workload():
    op = TM.OperatingPoint.green500()
    wl = TW.SyntheticWorkload(profile=TE.ConstantLoad(duration_s=100.0))
    solo = wl.execute(op).energy_j
    rec = TraceRecorder()
    TW.SyntheticWorkload(profile=TE.SyntheticHPL(300.0)).execute(
        op, recorder=rec)
    t_prev = rec.t_last
    shared = wl.execute(op, recorder=rec)
    assert float(shared.power_trace.t[-1]) >= t_prev + 100.0
    assert shared.energy_j == pytest.approx(solo, rel=1e-9)
    # the same on the JAX package's bus
    jrec = JRecorder()
    JCl.SyntheticWorkload(profile=JE.SyntheticHPL(300.0)).execute(
        JM.OperatingPoint.green500(), recorder=jrec)
    jshared = JCl.SyntheticWorkload(
        profile=JE.ConstantLoad(duration_s=100.0)).execute(
        JM.OperatingPoint.green500(), recorder=jrec)
    _close(shared.energy_j, jshared.energy_j)


def test_hpl_workload_runs_on_the_cpu():
    rec = TraceRecorder()
    rec.emit(0.0, {"chip": 10.0})
    rec.emit(3.0, {"chip": 10.0})
    for f_mhz, mode in ((774.0, "efficiency"), (900.0, "performance")):
        res = TW.HPLWorkload(cfg=SMOKE_HPL, device="cpu").execute(
            _op("t", f_mhz=f_mhz), recorder=rec)
        assert res.details["passed"] and res.perf_gflops > 0
        assert isinstance(res.power_trace, PowerTrace)
        t_end = float(res.power_trace.t[-1])
        assert res.energy_j == pytest.approx(
            res.power_trace.energy_j(t0=t_end - res.wall_s, t1=t_end),
            rel=REL)
        assert res.details["op_f_mhz"] == f_mhz
        # the earlier 10 W phase on the bus is not billed to the run
        assert res.energy_j == pytest.approx(
            res.power_trace.components["chip"][-1] * res.wall_s, rel=1e-9)
        assert res.power_trace.components["chip"][0] == 10.0


def test_hpl_workload_tuned_raises():
    with pytest.raises(NotImplementedError, match="autotuner"):
        TW.HPLWorkload(cfg=HPLConfig(n=64, block=16), tuned=True,
                       device="cpu").execute(TM.OperatingPoint.green500())


def _jax_field(lattice, seed):
    """The field the JAX package's ``LQCDSolveWorkload`` draws."""
    ku, kr, ki = jax.random.split(jax.random.PRNGKey(seed), 3)
    U = jax_random_su3(ku, lattice)
    b = (jax.random.normal(kr, lattice + (4, 3))
         + 1j * jax.random.normal(ki, lattice + (4, 3))
         ).astype(jnp.complex64)
    return U, b


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_lqcd_workload_on_the_jax_field_matches_jax(monkeypatch, seed,
                                                     calibrated):
    lattice = TC.SMOKE_LATTICE.shape
    U, b = _jax_field(lattice, seed)

    def field(shape, s, device):
        assert (tuple(shape), s, device) == (lattice, seed, "cpu")
        return (convert.gauge_from_numpy(np.asarray(U), "cpu"),
                convert.spinor_from_numpy(np.asarray(b), "cpu"))

    monkeypatch.setattr(TW, "random_field_and_source", field)
    cal_t = cal_j = None
    if calibrated:
        from repro.lqcd.multichip_eo import analytic_lqcd_calibration as jana
        cal_t = analytic_lqcd_calibration(lattice)
        cal_j = jana(lattice)
    op_t, op_j = TM.OperatingPoint.green500(), JM.OperatingPoint.green500()
    a = TW.LQCDSolveWorkload(seed=seed, calibration=cal_t,
                             device="cpu").execute(op_t)
    b = JCl.LQCDSolveWorkload(seed=seed, calibration=cal_j).execute(op_j)
    assert a.details["converged"] and b.details["converged"]
    assert a.details["iters"] == b.details["iters"]
    assert a.details["rel_residual"] <= 1e-6
    _close([a.perf_gflops, a.wall_s, a.energy_j, a.gflops_per_w],
           [b.perf_gflops, b.wall_s, b.energy_j, b.gflops_per_w])
    # energy given the port's own counts, through the JAX model
    scfg = TC.SMOKE_LATTICE.solver
    hw = JSolverHW() if cal_j is None else JSolverHW(
        name="x", bandwidth_gbs=cal_j.eff_bw_gbs, bw_fraction=1.0,
        power_w=cal_j.busy_w)
    if cal_j is None:
        hw = JSolverHW(power_w=JM.gpu_power_throttled(
            op_j.f_mhz, op_j.vid, temp_c=op_j.temperature(), util=1.0))
    rep = solver_energy("x", TC.SMOKE_LATTICE.volume, a.details["iters"],
                        outer_ops=a.details["outer_iters"],
                        inner_real_bytes=2 if scfg.mixed_precision else 4,
                        even_odd=True, hw=hw)
    _close(a.energy_j, rep.energy_j)
    if calibrated:
        for k in ("calibration_source", "cal_n_devices"):
            assert a.details[k] == b.details[k]
        _close([a.details["cal_gflops"], a.details["cal_vs_analytic"]],
               [b.details["cal_gflops"], b.details["cal_vs_analytic"]])


def test_lqcd_workload_draws_its_own_field_by_default():
    res = TW.LQCDSolveWorkload(device="cpu").execute(
        TM.OperatingPoint.green500())
    assert res.details["converged"] and res.details["rel_residual"] <= 1e-6
    t_end = float(res.power_trace.t[-1])
    assert res.energy_j == pytest.approx(
        res.power_trace.energy_j(t0=t_end - res.wall_s, t1=t_end), rel=REL)


def test_run_executes_both_workloads_on_the_cpu():
    from repro_torch.lqcd import measured_lqcd_calibration
    cal = measured_lqcd_calibration(TC.SMOKE_LATTICE.shape, device="cpu")
    res = TCl.run([TW.LQCDSolveWorkload(lattice=TC.SMOKE_LATTICE,
                                        calibration=cal, device="cpu"),
                   TW.HPLWorkload(cfg=SMOKE_HPL, device="cpu")])
    assert [r.kind for r in res.results] == ["lqcd", "hpl"]
    lq, hpl = res.results
    assert lq.details["converged"] and hpl.details["passed"]
    assert lq.details["calibration_source"] == "measured"
    # each workload runs at the point its placement resolved to
    by_name = {p.job.name: p.op for p in res.schedule.placements}
    assert lq.details["op_f_mhz"] == by_name["lqcd"].f_mhz == 774.0
    assert hpl.details["op_f_mhz"] == by_name["hpl"].f_mhz
    for r in res.results:
        t_end = float(r.power_trace.t[-1])
        assert r.energy_j == pytest.approx(
            r.power_trace.energy_j(t0=t_end - r.wall_s, t1=t_end), rel=REL)
        assert r.gflops_per_w > 0
    # the LQCD result burns the calibration's watts at its rate's bandwidth
    assert lq.energy_j == pytest.approx(cal.busy_w * lq.wall_s, rel=1e-9)
    assert res.efficiency(3).mflops_per_w > 0


@pytest.mark.parametrize("f_mhz", [300.0, 662.0, 774.0, 900.0])
def test_plan_at_caps_the_clock_grid_at_the_operating_point(f_mhz):
    from types import SimpleNamespace

    from repro_torch.config import EnergyConfig
    from repro_torch.core.energy.dvfs import plan_frequency
    ac = SimpleNamespace(compute_s=1.0, memory_s=0.2, collective_s=0.1,
                         flops=1e12)
    plan = TW._plan_at(ac, "performance", _op("t", f_mhz=f_mhz))
    cap = f_mhz / TM.STOCK_MHZ
    assert plan.freq_scale <= max(cap, 0.3) + 1e-9
    grid = tuple(f for f in EnergyConfig().freq_grid if f <= cap + 1e-9) \
        or (float(np.clip(cap, 0.3, 1.0)),)
    want = plan_frequency(1.0, 0.2, 0.1, flops_per_step=1e12,
                          cfg=EnergyConfig(mode="performance",
                                           freq_grid=grid))
    assert plan == want
    assert TW._plan_at(ac, "efficiency", None) == plan_frequency(
        1.0, 0.2, 0.1, flops_per_step=1e12, cfg=EnergyConfig())
