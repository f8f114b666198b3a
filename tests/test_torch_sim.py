"""The port's online cluster simulator (``repro_torch.cluster.sim`` with
its ``events``, ``resilience`` and ``stats`` modules and
``repro_torch.distributed.fault``) against the JAX package's: the same
arrivals through both ``simulate`` must give the same placements, the
same job records, the same drawn outages, the same ``SimStats`` and the
same merged ``PowerTrace``, every array equal with ``==`` (no tolerance:
the port is a copy of numpy code).  The scenarios are the reference
tests' (``tests/test_cluster_sim.py``, ``tests/test_resilience.py``): the
batch oracle, seeded Poisson streams with failures, requeues and drops,
backfill, Daly checkpoints and elastic restarts.  The workloads that run
real code (HPL, the LQCD solve) execute on the CPU here.
"""
import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.cluster as JCl  # noqa: E402
import repro.cluster.resilience as JR  # noqa: E402
import repro.distributed.fault as JF  # noqa: E402
import repro.power.model as JM  # noqa: E402
import repro_torch.cluster as TCl  # noqa: E402
import repro_torch.cluster.resilience as TR  # noqa: E402
import repro_torch.distributed.fault as TF  # noqa: E402
import repro_torch.power.model as TM  # noqa: E402
from repro.cluster.stats import compute_stats as j_compute_stats  # noqa: E402
from repro_torch.cluster.stats import compute_stats as t_compute_stats  # noqa: E402,E501

T = SimpleNamespace(C=TCl, F=TF, M=TM, R=TR, stats=t_compute_stats)
J = SimpleNamespace(C=JCl, F=JF, M=JM, R=JR, stats=j_compute_stats)

_SIM_META = ("online", "backfill", "failures")


def _same_trace(a, b, *, ignore_meta=()):
    """Bit for bit: every series equal sample for sample."""
    assert np.array_equal(a.t, b.t)
    assert sorted(a.components) == sorted(b.components)
    for name in a.components:
        assert np.array_equal(a.components[name], b.components[name]), name
    assert np.array_equal(a.flops_rate, b.flops_rate)
    assert sorted(a.aux) == sorted(b.aux)
    for name in a.aux:
        assert np.array_equal(a.aux[name], b.aux[name]), name
    assert ({k: v for k, v in a.meta.items() if k not in ignore_meta}
            == {k: v for k, v in b.meta.items() if k not in ignore_meta})


def _op(op):
    return None if op is None else dataclasses.asdict(op)


def _placements(res):
    return [(p.job.name, p.start, p.end, tuple(p.chips), p.sharded,
             _op(p.op)) for p in res.schedule.placements]


def _records(res):
    return [(r.uid, r.job.name, r.submit_s, r.start_s, r.end_s, r.requeues,
             r.state, r.completed_fraction, r.checkpoints, r.wait_s,
             r.progress) for r in res.records]


def _same_sim(got, want):
    """The port's SimResult equals the reference's in every field."""
    assert _placements(got) == _placements(want)
    assert _records(got) == _records(want)
    assert got.outages == want.outages
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert got.stats.goodput == want.stats.goodput
    assert got.stats.summary() == want.stats.summary()
    assert _op(got.op) == _op(want.op)
    assert got.makespan == want.makespan
    assert got.schedule.derated == want.schedule.derated
    assert got.schedule.meta == want.schedule.meta
    _same_trace(got.trace, want.trace)
    for level in (1, 2, 3):
        a, b = got.efficiency(level), want.efficiency(level)
        assert (a.mflops_per_w, a.avg_power_w) == \
            (b.mflops_per_w, b.avg_power_w)


def _green(P):
    return P.M.OperatingPoint.green500()


def _batch_order(jobs):
    return sorted(jobs, key=lambda j: -j.work_units)


# -- scenarios: each builds its arrivals in one package and simulates -------

def _oracle_uniform(P):
    top = P.C.ClusterTopology(n_nodes=4)
    jobs = [P.C.Job(f"lat{i}", 13.0, 600.0) for i in range(top.n_chips)]
    return dict(arrivals=jobs, topology=top, op=_green(P), dt_s=30.0,
                backfill=False)


def _oracle_mixed(P):
    rng = np.random.default_rng(0)
    jobs = [P.C.Job(f"j{i}", 13.0, float(rng.uniform(50.0, 700.0)))
            for i in range(40)]
    return dict(arrivals=_batch_order(jobs),
                topology=P.C.ClusterTopology(n_nodes=3), op=_green(P),
                dt_s=7.0, backfill=False)


def _oracle_round_robin(P):
    rng = np.random.default_rng(1)
    jobs = [P.C.Job(f"j{i}", 13.0, float(rng.uniform(100.0, 500.0)))
            for i in range(10)]
    return dict(arrivals=_batch_order(jobs),
                topology=P.C.ClusterTopology(n_nodes=2),
                policy="round_robin", op=_green(P), dt_s=11.0,
                backfill=False)


def _oracle_perf_scales(P):
    top = P.C.ClusterTopology(n_nodes=2, perf_scales=(
        1.0, 1.0, 0.9, 0.9, 0.8, 0.8, 1.0, 0.9))
    jobs = [P.C.Job(f"j{i}", 13.0, 400.0 + 37.0 * i) for i in range(12)]
    return dict(arrivals=_batch_order(jobs), topology=top, op=_green(P),
                dt_s=7.0, backfill=False)


def _oracle_mixed_ops(P):
    OP = P.M.OperatingPoint
    jobs = [P.C.Job(f"hpl{i}", 13.0, 400.0 + 31.0 * i,
                    preferred_op=OP(f_mhz=900.0), kind="hpl")
            for i in range(4)]
    jobs += [P.C.Job(f"lqcd{i}", 13.0, 350.0 + 17.0 * i,
                     preferred_op=_green(P), kind="lqcd") for i in range(8)]
    return dict(arrivals=_batch_order(jobs),
                topology=P.C.ClusterTopology(n_nodes=2), op=None, dt_s=7.0,
                backfill=False)


def _oracle_backfill(P):
    rng = np.random.default_rng(2)
    jobs = [P.C.Job(f"j{i}", 13.0, float(rng.uniform(60.0, 500.0)))
            for i in range(24)]
    return dict(arrivals=_batch_order(jobs),
                topology=P.C.ClusterTopology(n_nodes=2), op=_green(P),
                dt_s=7.0, backfill=True)


def _poisson_failures(seed):
    def case(P):
        rng = np.random.default_rng(3)
        jobs = [P.C.Job(f"j{i}", 13.0 if i % 4 else 52.0,
                        float(rng.uniform(600.0, 3600.0))) for i in range(60)]
        return dict(arrivals=P.C.PoissonArrivals(jobs, rate_per_s=1 / 120.0,
                                                 seed=7),
                    topology=P.C.ClusterTopology(n_nodes=4), op=_green(P),
                    dt_s=60.0, seed=seed,
                    failure_model=P.F.WeibullFailureModel(
                        mtbf_s=4 * 3600.0, repair_s=1800.0))
    return case


def _invariant_grid(n_nodes, n_jobs, rate_scale, backfill, fail):
    def case(P):
        rng = np.random.default_rng(n_jobs * 7 + n_nodes)
        jobs = [P.C.Job(f"j{i}", 52.0 if i % 5 == 4 else 13.0,
                        float(rng.uniform(120.0, 1800.0)))
                for i in range(n_jobs)]
        fm = P.F.WeibullFailureModel(mtbf_s=40 * 3600.0, repair_s=900.0) \
            if fail else None
        return dict(arrivals=P.C.PoissonArrivals(
            jobs, rate_per_s=rate_scale / 300.0, seed=n_jobs),
            topology=P.C.ClusterTopology(n_nodes=n_nodes), op=_green(P),
            dt_s=45.0, backfill=backfill, failure_model=fm,
            seed=n_jobs + 1)
    return case


def _hero_requeue(P):
    fm = P.F.WeibullFailureModel(mtbf_s=1200.0, shape=1.0, repair_s=300.0)
    return dict(arrivals=[P.C.Job("hero", 13.0, 3600.0)],
                topology=P.C.ClusterTopology(n_nodes=1), op=_green(P),
                dt_s=30.0, failure_model=fm, seed=3, max_requeues=50)


def _requeue_budget(P):
    fm = P.F.WeibullFailureModel(mtbf_s=600.0, shape=1.0, repair_s=60.0)
    return dict(arrivals=[P.C.Job("doomed", 13.0, 50000.0)],
                topology=P.C.ClusterTopology(n_nodes=1), op=_green(P),
                dt_s=300.0, failure_model=fm, seed=1, max_requeues=2)


def _mixed_width(backfill, n_nodes=4, n_jobs=80):
    def case(P):
        rng = np.random.default_rng(8)
        jobs = [P.C.Job(f"j{i}", 52.0 if i % 3 == 0 else 13.0,
                        float(rng.uniform(300.0, 2400.0)))
                for i in range(n_jobs)]
        return dict(arrivals=P.C.PoissonArrivals(jobs, rate_per_s=1 / 40.0,
                                                 seed=9),
                    topology=P.C.ClusterTopology(n_nodes=n_nodes),
                    op=_green(P), dt_s=60.0, backfill=backfill)
    return case


def _checkpointed(checkpoint_kw, seed=3, jobs=(("hero", 3600.0),),
                  n_nodes=1, **fm_kw):
    def case(P):
        fm = P.F.WeibullFailureModel(**(fm_kw or dict(
            mtbf_s=1200.0, shape=1.0, repair_s=300.0)))
        ckpt = None if checkpoint_kw is None \
            else P.C.CheckpointPolicy(**checkpoint_kw)
        return dict(arrivals=[P.C.Job(n, 13.0, w) for n, w in jobs],
                    topology=P.C.ClusterTopology(n_nodes=n_nodes),
                    op=_green(P), dt_s=30.0, failure_model=fm, seed=seed,
                    max_requeues=300, checkpoint=ckpt)
    return case


def _no_failure_checkpoint(P):
    jobs = _batch_order([P.C.Job(f"j{i}", 13.0, 300.0 + 41.0 * i)
                         for i in range(10)])
    return dict(arrivals=jobs, topology=P.C.ClusterTopology(n_nodes=2),
                op=_green(P), dt_s=13.0, backfill=False,
                checkpoint=P.C.CheckpointPolicy(), elastic=True)


def _elastic(elastic):
    def case(P):
        fm = P.F.WeibullFailureModel(mtbf_s=5000.0, shape=1.0,
                                     repair_s=12000.0)
        jobs = [P.C.Job("big", 13.0, 24000.0, shardable=True),
                P.C.Job("f0", 13.0, 15000.0, shardable=False),
                P.C.Job("f1", 13.0, 15000.0, shardable=False),
                P.C.Job("f2", 13.0, 15000.0, shardable=False)]
        return dict(arrivals=jobs, topology=P.C.ClusterTopology(n_nodes=2),
                    policy="round_robin", op=_green(P), dt_s=60.0,
                    failure_model=fm, seed=14, max_requeues=200,
                    checkpoint=P.C.CheckpointPolicy(), elastic=elastic)
    return case


def _power_capped(P):
    rng = np.random.default_rng(4)
    jobs = [(float(t), P.C.Job(f"j{i}", 13.0, float(rng.uniform(60, 900))))
            for i, t in enumerate(np.cumsum(rng.exponential(30.0, 20)))]
    return dict(arrivals=P.C.TraceArrivals(jobs),
                topology=P.C.ClusterTopology(n_nodes=2), op=None,
                power_cap_w=1500.0, dt_s=20.0, usd_per_kwh=0.31,
                network_w=55.0)


SCENARIOS = {
    "oracle_uniform": _oracle_uniform,
    "oracle_mixed_durations": _oracle_mixed,
    "oracle_round_robin": _oracle_round_robin,
    "oracle_perf_scales": _oracle_perf_scales,
    "oracle_mixed_ops": _oracle_mixed_ops,
    "oracle_backfill": _oracle_backfill,
    "poisson_failures_seed5": _poisson_failures(5),
    "poisson_failures_seed6": _poisson_failures(6),
    "grid_1n_fcfs": _invariant_grid(1, 12, 0.5, False, False),
    "grid_2n_backfill_fail": _invariant_grid(2, 30, 3.0, True, True),
    "grid_4n_fcfs_fail": _invariant_grid(4, 25, 1.0, False, True),
    "grid_3n_backfill": _invariant_grid(3, 1, 0.2, True, False),
    "hero_requeue": _hero_requeue,
    "requeue_budget_drop": _requeue_budget,
    "mixed_width_fcfs": _mixed_width(False),
    "mixed_width_backfill": _mixed_width(True),
    "mixed_width_2n_backfill": _mixed_width(True, n_nodes=2, n_jobs=40),
    "checkpoint_none": _checkpointed(None),
    "checkpoint_daly": _checkpointed({}),
    "checkpoint_fixed_30s": _checkpointed(dict(interval_s=30.0), jobs=tuple(
        (f"j{i}", 6000.0) for i in range(8)), n_nodes=2, mtbf_s=4000.0,
        shape=1.0, repair_s=300.0),
    "checkpoint_wasted_work": _checkpointed({}, seed=9, jobs=tuple(
        (f"j{i}", 2500.0) for i in range(4)), n_nodes=2),
    "checkpoint_no_failures": _no_failure_checkpoint,
    "elastic_off": _elastic(False),
    "elastic_on": _elastic(True),
    "power_capped_trace_arrivals": _power_capped,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_simulate_equals_the_reference(name):
    kw_t, kw_j = SCENARIOS[name](T), SCENARIOS[name](J)
    got = TCl.simulate(kw_t.pop("arrivals"), **kw_t)
    want = JCl.simulate(kw_j.pop("arrivals"), **kw_j)
    _same_sim(got, want)


@pytest.mark.parametrize("name", [n for n in SCENARIOS
                                  if n.startswith("oracle")]
                         + ["checkpoint_no_failures"])
def test_oracle_simulate_equals_the_ports_run(name):
    """Every arrival at t=0 and no failures: the simulator books what
    ``run()`` books, and its trace is ``run()``'s bit for bit."""
    kw = SCENARIOS[name](T)
    jobs = kw.pop("arrivals")
    batch = TCl.run(jobs, policy=kw.get("policy", "packed"),
                    topology=kw["topology"], op=kw["op"], dt_s=kw["dt_s"])
    sim = TCl.simulate(jobs, **kw)
    _same_trace(sim.trace, batch.trace, ignore_meta=_SIM_META)
    assert sim.trace.meta["online"] is True
    assert sim.makespan == batch.schedule.makespan


def test_scenarios_exercise_failures_checkpoints_and_drops():
    """The scenarios above reach the paths they are named for."""
    def sim(name):
        kw = SCENARIOS[name](T)
        return TCl.simulate(kw.pop("arrivals"), **kw)
    hero = sim("hero_requeue")
    assert hero.stats.node_failures >= 1 and hero.stats.requeues >= 1
    assert len(hero.schedule.placements) == hero.records[0].requeues + 1
    assert sim("requeue_budget_drop").records[0].state == "dropped"
    daly = sim("checkpoint_daly")
    assert daly.stats.checkpoints >= 1 and "storage" in daly.trace.components
    assert daly.stats.makespan_s < sim("checkpoint_none").stats.makespan_s
    big = {len(p.chips) for p in sim("elastic_on").schedule.placements
           if p.job.name == "big"}
    assert min(big) < 4 and 4 in big
    fcfs, easy = sim("mixed_width_fcfs"), sim("mixed_width_backfill")
    assert easy.stats.utilization > fcfs.stats.utilization
    assert sim("power_capped_trace_arrivals").schedule.derated


# -- distributed/fault.py ----------------------------------------------------

@pytest.mark.parametrize("seed,n_nodes,mtbf,shape", [
    (5, 4, 900.0, 1.2), (3, 64, 300.0, 0.7), (11, 3, 1800.0, 1.0)])
def test_node_outages_equal_the_reference(seed, n_nodes, mtbf, shape):
    kw = dict(mtbf_s=mtbf, shape=shape, repair_s=100.0)
    t, j = TF.WeibullFailureModel(**kw), JF.WeibullFailureModel(**kw)
    assert t.scale_s == j.scale_s
    got = list(t.node_outages(seed, n_nodes, 40.0 * mtbf))
    assert got and got == list(j.node_outages(seed, n_nodes, 40.0 * mtbf))
    # node 0's stream does not depend on how many nodes there are
    assert [o for o in got if o[0] == 0] == \
        list(t.node_outages(seed, 1, 40.0 * mtbf))
    # a shared generator draws in sequence, as the reference's does
    assert list(t.node_outages(np.random.default_rng(seed), 3, 10 * mtbf)) \
        == list(j.node_outages(np.random.default_rng(seed), 3, 10 * mtbf))
    a, b = t.node_streams(seed, 2), j.node_streams(seed, 2)
    assert [t.draw_uptime_s(r) for r in a] == [j.draw_uptime_s(r) for r in b]


def test_sim_outages_are_the_eager_draws():
    fm = TF.WeibullFailureModel(mtbf_s=1800.0, shape=1.0, repair_s=300.0)
    top = TCl.ClusterTopology(n_nodes=3)
    res = TCl.simulate([TCl.Job(f"j{i}", 13.0, 4000.0) for i in range(6)],
                       topology=top, op=_green(T), dt_s=60.0,
                       failure_model=fm, seed=11, max_requeues=100)
    assert res.outages
    horizon = max(t for _, t, _ in res.outages)
    # the two sum the same draws in another order: equal to 1e-9 s
    eager = {(n, round(a, 9), round(b, 9))
             for n, a, b in fm.node_outages(11, 3, horizon + 1e-9)}
    assert {(n, round(a, 9), round(b, 9)) for n, a, b in res.outages} \
        <= eager


def test_failure_model_validates():
    for bad in (dict(mtbf_s=-1.0), dict(shape=0.0), dict(repair_s=-1.0)):
        with pytest.raises(ValueError):
            TF.WeibullFailureModel(**bad)


# -- cluster/resilience.py ---------------------------------------------------

def test_daly_interval_and_job_state_bytes_equal_the_reference():
    for delta, mtbf in ((10.0, 3600.0), (10.0, math.inf), (0.0, 3600.0),
                        (10.0, 0.0), (3.3, 7.7e5)):
        assert TR.daly_interval_s(delta, mtbf) == \
            JR.daly_interval_s(delta, mtbf)
    for sb in (None, 2.0e9, 0.0):
        assert TR.job_state_bytes(TCl.Job("a", 13.0, 1.0, state_bytes=sb)) \
            == JR.job_state_bytes(JCl.Job("a", 13.0, 1.0, state_bytes=sb))
    assert (TR.DEFAULT_STORAGE_BW_BS, TR.DEFAULT_WRITE_W) == \
        (JR.DEFAULT_STORAGE_BW_BS, JR.DEFAULT_WRITE_W)


@pytest.mark.parametrize("kw", [{}, dict(min_interval_s=0.0),
                                dict(interval_s=120.0),
                                dict(interval_s=1.0, min_interval_s=30.0),
                                dict(storage_bw_bs=2.5e8, write_w=40.0)])
def test_checkpoint_policy_equals_the_reference(kw):
    t, j = TR.CheckpointPolicy(**kw), JR.CheckpointPolicy(**kw)
    for sb in (None, 0.0, 7.5e9):
        jt = TCl.Job("j", 13.0, 1.0, state_bytes=sb)
        jj = JCl.Job("j", 13.0, 1.0, state_bytes=sb)
        assert t.write_time_s(jt) == j.write_time_s(jj)
        for n in (1, 2, 4, 7):
            for mtbf in (math.inf, 100.0, 3.6e5):
                assert t.interval_for(jt, n_nodes=n, mtbf_node_s=mtbf) == \
                    j.interval_for(jj, n_nodes=n, mtbf_node_s=mtbf)
    for bad in (dict(storage_bw_bs=0.0), dict(interval_s=-1.0),
                dict(write_w=-1.0)):
        with pytest.raises(ValueError):
            TR.CheckpointPolicy(**bad)


@pytest.mark.parametrize("work,tau,delta", [
    (100.0, 30.0, 5.0), (60.0, 30.0, 5.0), (30.0, 30.0, 5.0),
    (100.0, math.inf, 5.0), (4999.0, 7.3, 0.4), (1.0, 2000.0, 60.0),
    (2500.0, 311.0, 13.0)])
def test_attempt_plan_equals_the_reference(work, tau, delta):
    t, j = TR.AttemptPlan(work, tau, delta), JR.AttemptPlan(work, tau, delta)
    assert (t.n_checkpoints, t.overhead_s, t.duration_s) == \
        (j.n_checkpoints, j.overhead_s, j.duration_s)
    assert t.checkpoint_windows() == j.checkpoint_windows()
    for frac in np.linspace(0.0, 1.1, 23):
        e = float(frac * t.duration_s)
        assert t.checkpoint_windows(until_s=e) == \
            j.checkpoint_windows(until_s=e)
        assert t.progress_at(e) == j.progress_at(e)


# -- cluster/events.py -------------------------------------------------------

def test_arrival_forms_equal_the_reference():
    def forms(P):
        jobs = [P.C.Job(f"j{i}", 13.0, 100.0 + i) for i in range(6)]
        wl = P.C.SyntheticWorkload(name="syn", work_units=77.0)
        return [jobs, P.C.batch_arrivals(jobs, t=3.0),
                P.C.TraceArrivals([(5.0 - i, j) for i, j in enumerate(jobs)]),
                P.C.PoissonArrivals(jobs, rate_per_s=0.01, seed=1, t0=2.0),
                [wl, (4.0, wl), jobs[0], P.C.Arrival(1.5, jobs[1])]]
    for a, b in zip(forms(T), forms(J)):
        got, want = TCl.as_arrivals(a), JCl.as_arrivals(b)
        assert [(x.t, x.job.name, x.job.work_units, x.workload is None)
                for x in got] == \
            [(x.t, x.job.name, x.job.work_units, x.workload is None)
             for x in want]
    assert [(a.t, a.job) for a in TCl.as_arrivals([T.C.Job("x", 1.0, 1.0)])
            ] == [(0.0, T.C.Job("x", 1.0, 1.0))]
    with pytest.raises(TypeError, match="cannot submit"):
        TCl.as_arrivals([object()])
    with pytest.raises(ValueError, match="non-negative"):
        TCl.as_arrivals([(-1.0, TCl.Job("x", 1.0, 1.0))])
    with pytest.raises(ValueError):
        TCl.PoissonArrivals([], rate_per_s=0.0)
    with pytest.raises(ValueError, match="empty"):
        TCl.simulate([])


# -- cluster/stats.py --------------------------------------------------------

def test_compute_stats_equals_the_reference():
    got = SCENARIOS["poisson_failures_seed5"](T)
    want = SCENARIOS["poisson_failures_seed5"](J)
    rt = TCl.simulate(got.pop("arrivals"), **got)
    rj = JCl.simulate(want.pop("arrivals"), **want)
    kw = dict(node_failures=3, node_downtime_s=5400.0, queue_peak=9,
              usd_per_kwh=0.4, wasted_chip_s=123.0, wasted_node_s=31.0,
              wasted_energy_j=4.5e4, checkpoints=2,
              checkpoint_overhead_s=26.0, checkpoint_overhead_chip_s=104.0,
              checkpoint_energy_j=650.0)
    a = T.stats(rt.records, rt.schedule.placements, rt.trace,
                rt.schedule.topology, **kw)
    b = J.stats(rj.records, rj.schedule.placements, rj.trace,
                rj.schedule.topology, **kw)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.goodput, a.energy_kwh, a.summary()) == \
        (b.goodput, b.energy_kwh, b.summary())


# -- execute=True: the workloads run at their placements' points -------------

def test_executed_simulation_on_the_cpu_keeps_the_trace():
    """``execute=True`` runs HPL and the LQCD solve (plain versions on the
    CPU) after the event loop: the trace and stats are those of
    ``execute=False``, and of the reference's simulator on the same
    arrivals, and each completed uid carries its result."""
    from repro.configs.hpl import SMOKE_HPL as J_HPL
    from repro_torch.configs.hpl import SMOKE_HPL

    def arrivals(P, hpl_cfg, **dev):
        return [(0.0, P.C.HPLWorkload(cfg=hpl_cfg, **dev)),
                (30.0, P.C.LQCDSolveWorkload(**dev)),
                (45.0, P.C.HPLWorkload(name="hpl2", cfg=hpl_cfg, **dev))]

    kw = dict(topology=TCl.ClusterTopology(n_nodes=1), dt_s=20.0,
              failure_model=TF.WeibullFailureModel(mtbf_s=2000.0, shape=1.0,
                                                   repair_s=100.0),
              seed=3, checkpoint=TCl.CheckpointPolicy())   # one kill
    ex = TCl.simulate(arrivals(T, SMOKE_HPL, device="cpu"), execute=True,
                      **kw)
    plain = TCl.simulate(arrivals(T, SMOKE_HPL, device="cpu"), **kw)
    kw.update(topology=JCl.ClusterTopology(n_nodes=1),
              failure_model=JF.WeibullFailureModel(mtbf_s=2000.0, shape=1.0,
                                                   repair_s=100.0),
              checkpoint=JCl.CheckpointPolicy())
    ref = JCl.simulate(arrivals(J, J_HPL), **kw)
    _same_sim(ex, plain)
    _same_sim(ex, ref)
    assert not plain.results
    done = [r.uid for r in ex.records if r.state == "completed"]
    assert sorted(ex.results) == done == [0, 1, 2]
    assert ex.stats.requeues >= 1 and ex.stats.checkpoints >= 1
    for uid in done:
        r = ex.results[uid]
        final = [p for p in ex.schedule.placements
                 if p.job is ex.records[uid].job][-1]
        assert r.details["op_f_mhz"] == final.op.f_mhz
    assert ex.results[0].details["passed"] and ex.results[2].details["passed"]
    assert ex.results[1].details["converged"]
