"""`ReplayServeWorkload`: a replay shard as a first-class cluster
workload (a copy of the JAX package's ``serve/replay.py``).

Wraps one :class:`repro_torch.serve.trace.RequestTrace` shard plus a
:class:`repro_torch.serve.engine.ContinuousBatchingEngine` behind the
``Workload`` protocol, so the online simulator can *place* it
(``job()`` — memory from the serve roofline, work units from the
shard's reference-point replay makespan), *fail and requeue* it like
any batch job, and optionally *execute* it at the placement's resolved
operating point (``simulate(..., execute=True)``) to get
per-request latency/energy details.

``serve_replay`` is registered as a memory-bound kind
(``repro_torch.cluster.scheduler.MEMORY_BOUND_KINDS``): decode is
bandwidth-bound, so a clock derate leaves the placement duration at
rate 1.0 — the paper's thesis, wired into the scheduler's rate model.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

from repro_torch.cluster.scheduler import Job
from repro_torch.cluster.workload import (WorkloadResult, _result,
                                    register_workload)
from repro_torch.power.model import H100_SXM, ChipTable, OperatingPoint
from repro_torch.power.trace import TraceRecorder
from repro_torch.serve.engine import ContinuousBatchingEngine, ServeCostModel
from repro_torch.serve.trace import RequestTrace, poisson_trace


@register_workload("serve_replay")
@dataclass
class ReplayServeWorkload:
    """One request-trace shard served by one continuously-batched chip.

    ``trace=None`` synthesizes a small seeded Poisson shard at half the
    replica's steady-state capacity (a usable default for scheduler
    tests and demos).  ``chip`` prices the shard's steps (an H100 SXM
    by default)."""

    name: str = "serve_replay"
    trace: Optional[RequestTrace] = None
    arch: str = "llama3-8b"
    max_batch: int = 8
    prompt_len: int = 64               # cost-model reference shape
    gen: int = 32
    smoke: bool = True
    kv_int8: bool = False
    kv_budget_tokens: Optional[int] = None
    slo_s: Optional[float] = None
    mode: str = "efficiency"
    seed: int = 0
    preferred_op: Optional[OperatingPoint] = None
    chip: ChipTable = H100_SXM
    _cost_cache: Optional[ServeCostModel] = field(
        default=None, init=False, repr=False, compare=False)
    _ref_cache: Optional[Any] = field(
        default=None, init=False, repr=False, compare=False)

    def _cost(self) -> ServeCostModel:
        if self._cost_cache is None:
            self._cost_cache = ServeCostModel(
                self.arch, max_batch=self.max_batch,
                prompt_len=self.prompt_len, gen=self.gen,
                smoke=self.smoke, kv_int8=self.kv_int8, chip=self.chip)
        return self._cost_cache

    def engine(self) -> ContinuousBatchingEngine:
        return ContinuousBatchingEngine(
            self._cost(), kv_budget_tokens=self.kv_budget_tokens,
            mode=self.mode)

    def __post_init__(self):
        if self.trace is None:
            cost = self._cost()
            plan, _, _ = cost.plan(self.preferred_op, self.mode)
            t_pre, _ = cost.prefill_cost(self.prompt_len, self.max_batch)
            service_s = t_pre + self.gen * plan.step_time_s
            rate = 0.5 * self.max_batch / max(service_s, 1e-12)
            self.trace = poisson_trace(
                4 * self.max_batch, rate,
                prompt_lens=(self.prompt_len,), gen_lens=(self.gen,),
                seed=self.seed)

    def _reference(self):
        """The shard replayed once at its preferred point — its
        makespan calibrates ``Job.work_units`` (reference-chip
        seconds)."""
        if self._ref_cache is None:
            op = self.preferred_op or OperatingPoint.green500()
            self._ref_cache = self.engine().replay(self.trace, op=op,
                                                   slo_s=self.slo_s)
        return self._ref_cache

    def job(self) -> Job:
        pre, dec = self._cost().workload._costs()
        mem_gb = max((pre.hbm_bytes + dec.hbm_bytes) / 1e9, 0.1)
        return Job(self.name, mem_gb,
                   work_units=self._reference().span_s,
                   shardable=False, preferred_op=self.preferred_op,
                   kind=self.kind, state_bytes=self.state_bytes())

    def state_bytes(self) -> float:
        # serving is stateless: dropped requests are retried, not
        # restored — checkpointing never triggers for replay shards
        return 0.0

    def execute(self, op: OperatingPoint, *,
                recorder: Optional[TraceRecorder] = None) -> WorkloadResult:
        res = self.engine().replay(self.trace, op=op, recorder=recorder,
                                   slo_s=self.slo_s)
        st = res.stats
        perf = res.trace.total_flops(res.t_off, res.t_off + res.span_s) \
            / max(res.span_s, 1e-12)
        details = dict(requests=st.n_requests, completed=st.completed,
                       p50_latency_s=st.p50_latency_s,
                       p99_latency_s=st.p99_latency_s,
                       p99_ttft_s=st.p99_ttft_s,
                       j_per_request=st.j_per_request,
                       j_per_token=st.j_per_token,
                       j_per_gen_token=st.j_per_gen_token,
                       slo_compliance=st.slo_compliance,
                       freq_scale=res.plan.freq_scale)
        return _result(self, op, res.trace, perf, res.span_s,
                       window=(res.t_off, res.t_off + res.span_s),
                       **details)


def replay_shards(trace: RequestTrace, n_shards: int,
                  **kwargs) -> List[ReplayServeWorkload]:
    """Split a cluster-wide request stream round-robin into ``n_shards``
    placeable workloads (each keeps ~1/n of the rate)."""
    return [ReplayServeWorkload(name=f"serve_replay/{i}", trace=shard,
                                **kwargs)
            for i, shard in enumerate(trace.shard(n_shards))]
