"""Unified Workload API + power-aware cluster scheduler of the port (a
copy of the JAX package's ``repro.cluster``, batch path only).

Every workload entry point the port has (HPL and the LQCD solve on the
card, synthetic loads) is normalized behind one :class:`Workload`
protocol, placed by a RAPS-style scheduler onto the 160-node / 4-GPU
L-CSC topology, and merged into a single cluster-level
:class:`repro_torch.power.PowerTrace`:

  :mod:`repro_torch.cluster.workload`   Workload protocol, registry,
                                        adapters
  :mod:`repro_torch.cluster.scheduler`  Job/Chip/Placement, topologies,
                                        policies, power-cap enforcement,
                                        straggler models, the ChipPool
  :mod:`repro_torch.cluster.run`        ``run(jobs, policy)``

Quick use::

    from repro_torch.cluster import HPLWorkload, LQCDSolveWorkload, run
    res = run([HPLWorkload(), LQCDSolveWorkload()], policy="packed")
    res.trace.avg_power()      # merged cluster watts
    res.efficiency(3)          # Green500 L3 over the merged trace

The JAX package's online simulator, arrival sources, resilience and
statistics modules are not ported yet (ROADMAP A7).
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
    SyntheticWorkload,
    Workload,
    WorkloadResult,
    list_workloads,
    make_workload,
    register_workload,
)
from repro_torch.cluster.run import ClusterRunResult, run  # noqa: F401
