"""The port's trace-replay serving (``repro_torch.serve``) against the JAX
package's (``repro.serve``): the request-trace format (either package
loads the other's files), the seeded generators, the continuous-batching
engine, the serve statistics, the ``serve_replay`` workload alone and
through the online simulator, the autoscaling fleet with and without
replica failures, and the executed-group runtime.

The analytic pieces are fed a chip table built from the reference's TPU
constants (``test_torch_analytic.TPU_TABLE``); every record, statistic
and trace array must then equal the reference's with ``==``.  The
executed runtime runs the mamba2-370m smoke model on the CPU (the plain
versions of the kernels) with the JAX package's weights, carried over by
``convert.params_from_numpy``: its greedy tokens must equal the JAX
runtime's.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.cluster as JCl  # noqa: E402
import repro.serve as JS  # noqa: E402
import repro_torch.cluster as TCl  # noqa: E402
import repro_torch.serve as TS  # noqa: E402
from repro.config import smoke_config as jax_smoke_config  # noqa: E402
from repro.distributed.fault import WeibullFailureModel as JWeibull  # noqa: E402,E501
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.power import model as JM  # noqa: E402
from repro.power.trace import TraceRecorder as JRecorder  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.config import smoke_config  # noqa: E402
from repro_torch.distributed.fault import WeibullFailureModel  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as RK  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as SK  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.power import model as TM  # noqa: E402
from repro_torch.power.trace import TraceRecorder  # noqa: E402
from test_torch_analytic import TPU_TABLE  # noqa: E402

T = dict(S=TS, C=TCl, M=TM, Rec=TraceRecorder, W=WeibullFailureModel,
         chip=dict(chip=TPU_TABLE))
J = dict(S=JS, C=JCl, M=JM, Rec=JRecorder, W=JWeibull, chip={})


def _same_trace(a, b):
    assert np.array_equal(a.t, b.t)
    assert sorted(a.components) == sorted(b.components)
    for k in a.components:
        assert np.array_equal(a.components[k], b.components[k]), k
    assert np.array_equal(a.flops_rate, b.flops_rate)
    assert sorted(a.aux) == sorted(b.aux)
    for k in a.aux:
        assert np.array_equal(a.aux[k], b.aux[k]), k


def _rec(r):
    return (r.idx, r.arrival_s, r.prompt_len, r.gen_len, r.admit_s,
            r.first_token_s, r.done_s, r.replica, r.retries, r.gave_up,
            r.wait_s, r.ttft_s, r.latency_s)


def _same_stats(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.j_per_request, a.j_per_token, a.j_per_gen_token,
            a.summary()) == (b.j_per_request, b.j_per_token,
                             b.j_per_gen_token, b.summary())


def _cost(P, arch="llama3-8b", **kw):
    return P["S"].ServeCostModel(arch, **{**P["chip"], **kw})


# -- the request-trace format -------------------------------------------------

GENERATORS = {
    "constant_burst": lambda S: S.constant_trace(5, t0=2.0),
    "constant_paced": lambda S: S.constant_trace(7, prompt_len=16,
                                                 gen_len=3, rate_per_s=10.0),
    "poisson": lambda S: S.poisson_trace(32, 10.0, prompt_lens=(16, 64),
                                         gen_lens=(8, 32), seed=3),
    "diurnal": lambda S: S.diurnal_trace(1000.0, rate_peak_per_s=10.0,
                                         rate_floor_per_s=0.5,
                                         prompt_lens=(64, 128),
                                         gen_lens=(16,), seed=4),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_generators_and_files_equal_the_reference(name, tmp_path):
    got, want = GENERATORS[name](TS), GENERATORS[name](JS)
    for a, b in ((got, want),) + tuple(zip(got.shard(3), want.shard(3))):
        for k in ("arrival_s", "prompt_len", "gen_len"):
            assert np.array_equal(getattr(a, k), getattr(b, k))
            assert getattr(a, k).dtype == getattr(b, k).dtype
        assert a.meta == b.meta
        assert (len(a), a.duration_s, a.total_prompt_tokens,
                a.total_gen_tokens) == (len(b), b.duration_s,
                                        b.total_prompt_tokens,
                                        b.total_gen_tokens)
    # either package loads the other's file
    got.meta["nested"] = {"a": [1, 2], "b": "x"}
    got.save(tmp_path / "t.npz")
    want.save(tmp_path / "j.npz")
    for loaded, orig in ((JS.RequestTrace.load(tmp_path / "t.npz"), got),
                         (TS.RequestTrace.load(tmp_path / "j.npz"), want)):
        assert np.array_equal(loaded.arrival_s, orig.arrival_s)
        assert np.array_equal(loaded.prompt_len, orig.prompt_len)
        assert np.array_equal(loaded.gen_len, orig.gen_len)
        assert loaded.meta == orig.meta


@pytest.mark.parametrize("arrival,prompt,gen", [
    ([0.0, 1.0], [8], [4, 4]), ([0.0, -1.0], [8, 8], [4, 4]),
    ([0.0, np.inf], [8, 8], [4, 4]), ([0.0, 1.0], [8, 0], [4, 4]),
    ([0.0, 1.0], [8, 8], [4, 2.5]), (np.zeros((2, 2)), np.ones((2, 2)),
                                     np.ones((2, 2)))])
def test_malformed_traces_are_refused(arrival, prompt, gen, tmp_path):
    for S in (TS, JS):
        with pytest.raises(ValueError):
            S.RequestTrace(np.array(arrival), np.array(prompt),
                           np.array(gen))
    np.savez(tmp_path / "bad.npz", arrival_s=np.zeros(2),
             prompt_len=np.ones(2))
    np.savez(tmp_path / "meta.npz", arrival_s=np.zeros(2),
             prompt_len=np.ones(2), gen_len=np.ones(2),
             meta=np.array("{not json"))
    with pytest.raises(ValueError, match="gen_len"):
        TS.RequestTrace.load(tmp_path / "bad.npz")
    with pytest.raises(ValueError, match="bad meta"):
        TS.RequestTrace.load(tmp_path / "meta.npz")
    for bad in (dict(duration_s=0.0, rate_peak_per_s=1.0),
                dict(duration_s=10.0, rate_peak_per_s=1.0,
                     rate_floor_per_s=2.0)):
        with pytest.raises(ValueError):
            TS.diurnal_trace(**bad)
    with pytest.raises(ValueError):
        TS.poisson_trace(3, 0.0)
    with pytest.raises(ValueError):
        TS.constant_trace(3).shard(0)


# -- the continuous-batching engine -------------------------------------------

def _replay_case(name):
    def case(P, eng_kw=None, **replay_kw):
        S = P["S"]
        op = P["M"].OperatingPoint.green500()
        cost = _cost(P, max_batch=4, prompt_len=64, gen=32)
        plan, _, _ = cost.plan(op)
        burst = S.constant_trace(4, prompt_len=64, gen_len=32)
        trace, eng = burst, {}
        if name == "serial":
            trace, eng = S.constant_trace(3, prompt_len=64, gen_len=32), \
                dict(max_batch=1)
        elif name == "kv_budget":
            trace, eng = S.constant_trace(4, prompt_len=64, gen_len=32), \
                dict(kv_budget_tokens=2 * 96)
        elif name == "idle_gap":
            service = 100.0 * (32 * plan.step_time_s)
            trace = S.RequestTrace(np.array([0.0, service]),
                                   np.full(2, 64), np.full(2, 32))
        elif name == "poisson_slo":
            rate = 0.5 * 4 / (32 * plan.step_time_s)
            trace = S.poisson_trace(40, rate, prompt_lens=(64, 16, 128),
                                    gen_lens=(32, 8), seed=5)
            replay_kw["slo_s"] = 1e-3
        elif name == "performance_900":
            eng = dict(mode="performance")
            op = P["M"].OperatingPoint(f_mhz=900.0)
        elif name == "derated_shared_bus":
            op = P["M"].OperatingPoint(f_mhz=500.0)
            rec = P["Rec"](source="test")
            rec.emit(0.0, {"chip": 42.0}, flops_rate=0.0)
            rec.emit(5.0, {"chip": 42.0}, flops_rate=0.0)
            replay_kw["recorder"] = rec
        return S.ContinuousBatchingEngine(cost, **eng).replay(
            trace, op=op, **replay_kw), cost
    return case


REPLAYS = ["burst", "serial", "kv_budget", "idle_gap", "poisson_slo",
           "performance_900", "derated_shared_bus"]


@pytest.mark.parametrize("name", REPLAYS)
def test_replay_equals_the_reference(name):
    (got, tcost), (want, _) = _replay_case(name)(T), _replay_case(name)(J)
    assert [_rec(r) for r in got.records] == [_rec(r) for r in want.records]
    _same_stats(got.stats, want.stats)
    _same_trace(got.trace, want.trace)
    assert (got.t_off, got.span_s, got.energy_j) == \
        (want.t_off, want.span_s, want.energy_j)
    assert dataclasses.asdict(got.plan) == dataclasses.asdict(want.plan)
    assert [got.request_energy_j(i) for i in range(len(got.records))] == \
        [want.request_energy_j(i) for i in range(len(want.records))]
    assert all(r.tokens is None for r in got.records)


def test_replay_prices_the_h100_by_default():
    cost = TS.ServeCostModel("llama3-8b", max_batch=4)
    assert cost.chip is TM.H100_SXM
    rep = TS.Replica(cost)
    assert rep.p_idle == TM.h100_chip_power(rep.plan.freq_scale, 0.0, 0.0)
    op = TM.OperatingPoint.green500()
    burst = TS.constant_trace(4, prompt_len=64, gen_len=32)
    res = TS.ContinuousBatchingEngine(cost).replay(burst, op=op)
    ref = cost.workload.execute(op)
    assert res.span_s == pytest.approx(ref.wall_s, rel=1e-12)
    assert res.stats.energy_j == pytest.approx(ref.energy_j, rel=1e-9)
    with pytest.raises(ValueError, match="empty"):
        TS.ContinuousBatchingEngine(cost).replay(TS.constant_trace(0))
    with pytest.raises(ValueError, match="never be admitted"):
        TS.ContinuousBatchingEngine(cost, kv_budget_tokens=16).replay(burst)


def test_serve_stats_helpers_equal_the_reference():
    from repro.power.trace import PowerTrace as JTrace
    from repro.serve.stats import request_energy_j as j_req
    from repro_torch.power.trace import PowerTrace
    from repro_torch.serve.stats import request_energy_j as t_req
    t = np.array([0.0, 1.0, 1.0, 2.0, 2.0, 3.5])
    y = np.array([10.0, 10.0, 20.0, 20.0, 5.0, 5.0])
    for w in ((0.0, 2.0), (1.0, 2.0), (0.5, 1.5), (2.0, 2.0), (2.0, 1.0),
              (-1.0, 9.0), (0.25, 3.25)):
        assert TS.step_window_integral(t, y, *w) == \
            JS.step_window_integral(t, y, *w)
    aux = {"batch": np.array([1.0, 1.0, 3.0, 3.0, 0.0, 0.0])}
    a = PowerTrace(t, {"chip": y}, np.zeros(6), aux=dict(aux))
    b = JTrace(t, {"chip": y}, np.zeros(6), aux=dict(aux))
    assert t_req(a, 0.5, 3.0) == j_req(b, 0.5, 3.0)
    with pytest.raises(ValueError, match="batch"):
        t_req(PowerTrace(t, {"chip": y}, np.zeros(6)), 0.0, 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        TS.emit_step_intervals(TraceRecorder(source="t"),
                               [(0.0, 1.0, 5.0, 0.0, 1),
                                (2.0, 3.0, 5.0, 0.0, 1)])


# -- serve_replay as a cluster workload ---------------------------------------

def _replay_workload(P, **kw):
    return P["S"].ReplayServeWorkload(**{**P["chip"], "max_batch": 4,
                                         **kw})


@pytest.mark.parametrize("kw", [dict(seed=2), dict(seed=3, slo_s=1e-4),
                                dict(arch="mamba2-370m", smoke=False,
                                     prompt_len=512, gen=16, seed=1)])
def test_replay_workload_equals_the_reference(kw):
    got, want = _replay_workload(T, **kw), _replay_workload(J, **kw)
    a, b = got.job(), want.job()
    assert (a.name, a.mem_gb, a.work_units, a.shardable, a.kind,
            a.state_bytes) == (b.name, b.mem_gb, b.work_units, b.shardable,
                               b.kind, b.state_bytes)
    r = got.execute(TM.OperatingPoint(f_mhz=600.0))
    s = want.execute(JM.OperatingPoint(f_mhz=600.0))
    assert (r.perf_gflops, r.wall_s, r.energy_j, r.details) == \
        (s.perf_gflops, s.wall_s, s.energy_j, s.details)
    _same_trace(r.power_trace, s.power_trace)


def test_replay_workloads_register_lazily_and_shard():
    from repro.serve.replay import replay_shards as j_shards
    wl = TCl.make_workload("serve_replay", max_batch=4)
    assert isinstance(wl, TS.ReplayServeWorkload) and wl.kind == \
        "serve_replay"
    assert TCl.WORKLOAD_REGISTRY["serve_replay"] is TS.ReplayServeWorkload
    tr = TS.poisson_trace(24, 1e5, seed=9)
    got = TS.replay_shards(tr, 3, max_batch=4, chip=TPU_TABLE)
    want = j_shards(JS.poisson_trace(24, 1e5, seed=9), 3, max_batch=4)
    assert [(w.name, w.job().work_units) for w in got] == \
        [(w.name, w.job().work_units) for w in want]
    with pytest.raises(KeyError, match="unknown"):
        TCl.make_workload("not_a_kind")


@pytest.mark.parametrize("execute", [False, True])
def test_replay_shards_through_the_simulator_equal_the_reference(execute):
    """Three shards and an HPL-sized job on one node with a failure that
    kills a shard: the simulator's placements, stats and trace and each
    shard's executed result equal the reference's."""
    def sim(P):
        shards = [(2.0 * i, w) for i, w in enumerate(
            P["S"].replay_shards(P["S"].poisson_trace(48, 4e4, seed=9), 3,
                                 max_batch=4, **P["chip"]))]
        shards.append((1e-3, P["C"].Job("big", 13.0, 5e-3)))
        return P["C"].simulate(
            shards, topology=P["C"].ClusterTopology(n_nodes=1),
            op=P["M"].OperatingPoint.green500(), dt_s=1e-4,
            failure_model=P["W"](mtbf_s=2e-3, shape=1.0, repair_s=1e-4),
            seed=1, max_requeues=20, execute=execute)
    got, want = sim(T), sim(J)
    assert [(p.job.name, p.start, p.end, tuple(p.chips))
            for p in got.schedule.placements] == \
        [(p.job.name, p.start, p.end, tuple(p.chips))
         for p in want.schedule.placements]
    assert dataclasses.asdict(got.stats) == dataclasses.asdict(want.stats)
    assert got.outages == want.outages
    _same_trace(got.trace, want.trace)
    assert sorted(got.results) == sorted(want.results)
    assert bool(got.results) == execute
    for uid in got.results:
        assert got.results[uid].details == want.results[uid].details
        assert got.results[uid].energy_j == want.results[uid].energy_j


# -- the autoscaling fleet ----------------------------------------------------

def _fleet_case(P, n_max=4, seed=7, util=0.55):
    S = P["S"]
    cost = _cost(P, max_batch=8, prompt_len=64, gen=32)
    plan, _, _ = cost.plan()
    t_pre, _ = cost.prefill_cost(64, 8)
    service = t_pre + 32 * plan.step_time_s
    cap_rps = 8 / service
    day = 600.0 / (util * n_max * cap_rps)
    tr = S.diurnal_trace(day, rate_peak_per_s=0.75 * n_max * cap_rps,
                         rate_floor_per_s=0.05 * n_max * cap_rps,
                         prompt_lens=(64,), gen_lens=(32,), seed=seed)
    probe = S.Replica(cost)
    cap = n_max * (probe.p_busy + S.HOST_SHARE_W) + 1.0
    return cost, tr, cap, day / 288.0, 8.0 * service + 3.0 * day / 96.0


FLEETS = {
    "flat_out": lambda P, S, c: S.flat_out(4, power_cap_w=c),
    "autoscaled": lambda P, S, c: S.AutoscalePolicy(
        name="auto", n_max=4, n_min=1, dt_ctrl_s=_fleet_case(P)[3],
        power_cap_w=c),
    "capped_at_two": lambda P, S, c: S.AutoscalePolicy(
        name="capped", n_max=4, n_min=1, dt_ctrl_s=_fleet_case(P)[3],
        startup_s=_fleet_case(P)[3],
        power_cap_w=2 * (S.Replica(_fleet_case(P)[0]).p_busy
                         + S.HOST_SHARE_W) + 1.0),
}


def _fleet(P, name, failures=None, **kw):
    S = P["S"]
    cost, tr, cap, _, slo = _fleet_case(P)
    return S.run_fleet(cost, tr, FLEETS[name](P, S, cap), slo_s=slo,
                       failures=failures, **kw)


def _same_fleet(got, want):
    assert [_rec(r) for r in got.records] == [_rec(r) for r in want.records]
    _same_stats(got.stats, want.stats)
    _same_trace(got.trace, want.trace)
    assert np.array_equal(got.live_t, want.live_t)
    assert np.array_equal(got.live_n, want.live_n)
    assert (got.t_off, got.span_s, got.busy_w_per_replica,
            got.replica_failures, got.outages, got.n_live_peak,
            got.n_live_min) == (want.t_off, want.span_s,
                                want.busy_w_per_replica,
                                want.replica_failures, want.outages,
                                want.n_live_peak, want.n_live_min)


@pytest.mark.parametrize("name", list(FLEETS))
def test_fleet_equals_the_reference(name):
    got, want = _fleet(T, name), _fleet(J, name)
    _same_fleet(got, want)
    if name == "autoscaled":
        assert got.n_live_min < got.n_live_peak


@pytest.mark.parametrize("name,retries,mtbf_days", [("autoscaled", 2, 0.3),
                                                    ("flat_out", 0, 0.15)])
def test_fleet_with_replica_failures_equals_the_reference(name, retries,
                                                          mtbf_days):
    def fleet(P):
        mtbf = mtbf_days * 288.0 * _fleet_case(P)[3]    # of the trace's day
        return _fleet(P, name, failures=P["W"](mtbf_s=mtbf, shape=1.0,
                                               repair_s=mtbf / 3),
                      retry=P["S"].RetryPolicy(max_retries=retries,
                                               backoff_s=mtbf / 50,
                                               backoff_cap_s=mtbf / 5),
                      failure_seed=7)
    got, want = fleet(T), fleet(J)
    assert got.replica_failures >= 1 and got.stats.retries >= 1
    _same_fleet(got, want)


def test_fleet_refusals_and_retry_policy():
    cost, tr, cap, dt, slo = _fleet_case(T)
    with pytest.raises(ValueError, match="power cap"):
        TS.run_fleet(cost, tr, TS.AutoscalePolicy(n_max=4, n_min=2,
                                                  power_cap_w=50.0))
    with pytest.raises(ValueError, match="empty"):
        TS.run_fleet(cost, TS.constant_trace(0), TS.AutoscalePolicy())
    rp, jp = TS.RetryPolicy(5, 0.5, 4.0), JS.RetryPolicy(5, 0.5, 4.0)
    assert [rp.delay_s(i) for i in range(12)] == \
        [jp.delay_s(i) for i in range(12)]
    with pytest.raises(ValueError):
        TS.RetryPolicy(backoff_s=0.0)
    assert TS.HOST_SHARE_W == JS.HOST_SHARE_W


# -- the executed-group runtime -----------------------------------------------

ARCH = "mamba2-370m"


@pytest.fixture(scope="module")
def mamba2_weights():
    """The JAX package's smoke weights, and the same weights in the port."""
    cfg = smoke_config(ARCH)
    jp = jax_init_params(jax_smoke_config(ARCH), jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return jp, convert.params_from_numpy(tree, cfg, "cpu")


def test_executed_runtime_tokens_equal_the_jax_runtime(mamba2_weights):
    """Greedy tokens of three groups (prompt 17, 40 and 64 tokens: below,
    past and at two 32-token chunks) through both runtimes, on the CPU,
    with the same weights and the same numpy prompt stream."""
    jp, tp = mamba2_weights
    got = TS.ExecutedGroupRuntime(ARCH, params=tp, seed=4, device="cpu")
    want = JS.ExecutedGroupRuntime(ARCH, params=jp, seed=4)
    rk, sk = dict(RK.LAUNCHES), dict(SK.LAUNCHES)
    for s, gen, n in ((17, 5, 2), (40, 3, 3), (64, 4, 1)):
        a, b = got.run_group(s, gen, n), want.run_group(s, gen, n)
        assert a.shape == (n, gen) and a.dtype == np.int32
        assert np.array_equal(a, np.asarray(b))
    assert [g[:3] for g in got.groups] == [(17, 2, 5), (40, 3, 3),
                                           (64, 1, 4)]
    assert RK.LAUNCHES == rk and SK.LAUNCHES == sk     # plain versions


def test_executed_replay_equals_the_jax_runtime(mamba2_weights):
    """The runtime only attaches tokens: the stats and trace equal the
    replay without it, and each record's tokens equal the JAX
    runtime's."""
    jp, tp = mamba2_weights

    def replay(P, runtime):
        S = P["S"]
        cost = _cost(P, ARCH, max_batch=3, prompt_len=32, gen=6)
        tr = S.poisson_trace(7, 3e4, prompt_lens=(20, 32),
                             gen_lens=(4, 6), seed=2)
        return S.ContinuousBatchingEngine(cost, runtime=runtime).replay(
            tr, op=P["M"].OperatingPoint.green500())

    got = replay(T, TS.ExecutedGroupRuntime(ARCH, params=tp, seed=1,
                                            device="cpu"))
    bare = replay(T, None)
    want = replay(J, JS.ExecutedGroupRuntime(ARCH, params=jp, seed=1))
    _same_stats(got.stats, bare.stats)
    _same_trace(got.trace, bare.trace)
    _same_stats(got.stats, want.stats)
    assert [_rec(r) for r in got.records] == [_rec(r) for r in want.records]
    V = smoke_config(ARCH).vocab_size
    for r, s in zip(got.records, want.records):
        assert r.tokens.shape == (r.gen_len,)
        assert np.all((r.tokens >= 0) & (r.tokens < V))
        assert np.array_equal(r.tokens, np.asarray(s.tokens))
    assert all(r.tokens is None for r in bare.records)


def test_executed_runtime_takes_a_cut_config():
    """``cfg=`` (the port's own argument) runs another configuration: the
    tokens are those of the steps called directly on the same prompt."""
    from repro_torch.models import init_params
    from repro_torch.runtime import steps
    cfg = dataclasses.replace(smoke_config(ARCH), n_layers=1,
                              dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    rt = TS.ExecutedGroupRuntime(cfg=cfg, params=params, seed=6,
                                 device="cpu")
    got = rt.run_group(40, 4, 2)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 40))
    logits, cache = steps.make_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(prompt).to(torch.int32)})
    cache = steps.grow_decode_cache(cfg, cache, 2, 44)
    want = []
    for _ in range(4):
        want.append(torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None])
        logits, cache = steps.make_decode_step(cfg)(
            params, want[-1].to(torch.int32), cache)
    assert np.array_equal(got, torch.cat(want, 1).numpy())
    assert rt.cfg is cfg and rt.groups[0][:3] == (40, 2, 4)


def test_executed_runtime_refusals(monkeypatch):
    """The vlm and encdec families are refused, as in the reference, and
    so is the default card without one; llama3-8b and the int8 cache,
    refused before the attention families were ported, now run."""
    with pytest.raises(ValueError, match="token-only"):
        TS.ExecutedGroupRuntime("llava-next-mistral-7b", device="cpu")
    for arch, kv_int8 in (("llama3-8b", False), ("llama3-8b", True),
                          (ARCH, True)):
        rt = TS.ExecutedGroupRuntime(arch, kv_int8=kv_int8, device="cpu")
        toks = rt.run_group(9, 3, 2)
        assert toks.shape == (2, 3) and toks.dtype == np.int32
        assert ((0 <= toks) & (toks < rt.cfg.vocab_size)).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.ExecutedGroupRuntime(ARCH)


# -- the serve CLI's replay ---------------------------------------------------

def test_serve_cli_replays_a_reference_trace(tmp_path, capsys):
    """``--make-demo-trace`` writes a file the JAX package loads;
    ``--replay`` of a file the JAX package wrote prints the engine's
    report; ``--executed`` on the CPU attaches the model's tokens."""
    path = tmp_path / "day.npz"
    serve_cli.main(["--make-demo-trace", str(path), "--arch", "llama3-8b",
                    "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    ours = JS.RequestTrace.load(path)
    assert ours.meta["generator"] == "diurnal" and len(ours) > 0
    out = capsys.readouterr().out
    assert out.startswith(f"[trace] wrote {len(ours)} requests")

    ref = tmp_path / "ref.npz"
    JS.poisson_trace(6, 1e4, prompt_lens=(16,), gen_lens=(4,),
                     seed=3).save(ref)
    serve_cli.main(["--replay", str(ref), "--arch", ARCH, "--batch", "2",
                    "--prompt-len", "16", "--gen", "4", "--executed",
                    "--device", "cpu", "--slo-s", "1e-4"])
    out = capsys.readouterr().out.splitlines()
    cost = TS.ServeCostModel(ARCH, max_batch=2, prompt_len=16, gen=4)
    res = TS.ContinuousBatchingEngine(cost).replay(
        TS.RequestTrace.load(ref), slo_s=1e-4)
    assert out[0] == "[replay] 6 requests over " \
        f"{res.records[-1].arrival_s - res.records[0].arrival_s:.3g}s " \
        "(poisson)"
    assert out[1].startswith("[energy] decode dominant=")
    assert out[2] == "[replay] " + res.stats.summary()
    assert out[-1].startswith("sample: [") and math.isfinite(
        res.stats.energy_j)
