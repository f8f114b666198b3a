"""Unified Workload API + power-aware cluster scheduler of the port (a
copy of the JAX package's ``repro.cluster``).

Every workload entry point the port has (HPL and the LQCD solve on the
card, the train and serve roofline adapters, trace-replay serving,
synthetic loads) is normalized behind one :class:`Workload`
protocol, placed by a RAPS-style scheduler onto the 160-node / 4-GPU
L-CSC topology, and merged into a single cluster-level
:class:`repro_torch.power.PowerTrace`:

  :mod:`repro_torch.cluster.workload`   Workload protocol, registry,
                                        adapters
  :mod:`repro_torch.cluster.scheduler`  Job/Chip/Placement, topologies,
                                        policies, power-cap enforcement,
                                        straggler models, the ChipPool
  :mod:`repro_torch.cluster.run`        ``run(jobs, policy)``
  :mod:`repro_torch.cluster.sim`        online discrete-event simulator
                                        (arrival queues, backfill,
                                        failures)
  :mod:`repro_torch.cluster.events`     arrival sources (Poisson / trace)
  :mod:`repro_torch.cluster.resilience` Daly-interval CheckpointPolicy,
                                        per-attempt checkpoint schedules
  :mod:`repro_torch.cluster.stats`      RAPS-style end-of-run report

Quick use::

    from repro_torch.cluster import HPLWorkload, LQCDSolveWorkload, run
    res = run([HPLWorkload(), LQCDSolveWorkload()], policy="packed")
    res.trace.avg_power()      # merged cluster watts
    res.efficiency(3)          # Green500 L3 over the merged trace

Online operation (open queue, failures)::

    from repro_torch.cluster import Job, PoissonArrivals, simulate
    from repro_torch.distributed.fault import WeibullFailureModel
    jobs = [Job(f"lat{i}", 13.0, 3600.0) for i in range(500)]
    res = simulate(PoissonArrivals(jobs, rate_per_s=0.05, seed=1),
                   failure_model=WeibullFailureModel(mtbf_s=3.6e6))
    print(res.stats.summary())  # utilization, waits, energy, $ cost

``simulate(..., execute=True)`` runs each completed workload at its
final placement's operating point: HPL and the LQCD solve on the card.
"""
from repro_torch.cluster.scheduler import (  # noqa: F401
    GREEN500_TOPOLOGY,
    L_CSC_TOPOLOGY,
    S9150_DPM_STATES_MHZ,
    Chip,
    ChipPool,
    ClusterTopology,
    Job,
    Placement,
    PowerCapError,
    Schedule,
    Scheduler,
    SchedulingError,
    drop_slowest_pod,
    expected_slowdown,
    frequency_floor_mitigation,
    makespan,
    schedule_throughput,
    straggler_step_time,
    synchronous_rate,
    with_perf_floor,
)
from repro_torch.cluster.workload import (  # noqa: F401
    WORKLOAD_REGISTRY,
    HPLWorkload,
    LQCDSolveWorkload,
    ServeWorkload,
    SyntheticWorkload,
    TrainWorkload,
    Workload,
    WorkloadResult,
    list_workloads,
    make_workload,
    register_workload,
)
from repro_torch.cluster.run import ClusterRunResult, run  # noqa: F401
from repro_torch.cluster.events import (  # noqa: F401
    Arrival,
    PoissonArrivals,
    TraceArrivals,
    as_arrivals,
    batch_arrivals,
)
from repro_torch.cluster.resilience import (  # noqa: F401
    AttemptPlan,
    CheckpointPolicy,
    daly_interval_s,
    job_state_bytes,
)
from repro_torch.cluster.stats import JobRecord, SimStats  # noqa: F401
from repro_torch.cluster.sim import SimResult, simulate  # noqa: F401
