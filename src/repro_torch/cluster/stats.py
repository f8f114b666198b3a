"""End-of-run statistics for the online cluster simulator (a copy of the
JAX package's ``cluster/stats.py``).

RAPS reports a scheduling run as one summary block — utilization, wait
times, energy, cost at a $/kWh tariff — next to the power telemetry.
:class:`SimStats` is that block for :func:`repro_torch.cluster.sim.simulate`:
everything is derived from the per-job records, the committed
placements, and the merged :class:`repro_torch.power.PowerTrace`, so the
numbers and the trace can never disagree.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.cluster.scheduler import ClusterTopology, Job, Placement
from repro_torch.power.trace import PowerTrace

#: default electricity tariff [$ / kWh] — European industrial rate of
#: the paper's era (GSI's power bill is the stated motivation, §1)
DEFAULT_USD_PER_KWH = 0.25

COMPLETED = "completed"
DROPPED = "dropped"       # exceeded the requeue budget after failures


@dataclass
class JobRecord:
    """One submitted job's life: submit → (wait) → start → end, plus any
    failure-driven requeues along the way."""

    uid: int
    job: Job
    submit_s: float
    start_s: Optional[float] = None     # first dispatch (wait = start-submit)
    end_s: Optional[float] = None       # terminal completion time
    requeues: int = 0
    state: str = "queued"               # queued|running|completed|dropped
    #: work fraction durably preserved by the last completed checkpoint
    #: (the progress surface): a killed attempt restarts from here, not
    #: from zero — 0.0 without a CheckpointPolicy, 1.0 on completion
    completed_fraction: float = 0.0
    checkpoints: int = 0                # completed checkpoint writes

    @property
    def wait_s(self) -> Optional[float]:
        return None if self.start_s is None else self.start_s - self.submit_s

    @property
    def progress(self) -> float:
        return 1.0 if self.state == COMPLETED else self.completed_fraction


@dataclass(frozen=True)
class SimStats:
    """The RAPS-style end-of-run report."""

    jobs_submitted: int
    jobs_completed: int
    jobs_dropped: int
    requeues: int
    node_failures: int
    node_downtime_s: float              # node-seconds out of service
    makespan_s: float
    utilization: float                  # busy chip-seconds / capacity
    wait_mean_s: float
    wait_p95_s: float
    queue_peak: int
    energy_j: float
    avg_power_w: float
    cost_usd: float
    usd_per_kwh: float = DEFAULT_USD_PER_KWH
    #: chip-seconds of compute redone after failure kills (work executed
    #: since the last completed checkpoint — the whole attempt without a
    #: CheckpointPolicy), and the busy-watt joules that compute burned.
    #: Both are exactly 0 in the no-failure oracle case.
    wasted_chip_s: float = 0.0
    wasted_node_s: float = 0.0          # same waste in node-seconds
    wasted_energy_j: float = 0.0
    checkpoints: int = 0                # completed checkpoint writes
    checkpoint_overhead_s: float = 0.0  # wall seconds paused for writes
    checkpoint_energy_j: float = 0.0    # storage-component write joules
    extras: Dict[str, float] = field(default_factory=dict)

    @property
    def energy_kwh(self) -> float:
        return self.energy_j / 3.6e6

    @property
    def goodput(self) -> float:
        """Fraction of committed busy chip-seconds that was *useful*
        first-time compute: 1 − (redone work + checkpoint pauses) /
        busy.  The resilience benchmark's second gate (next to
        energy-to-completion)."""
        total = self._busy_chip_s
        if total <= 0.0:
            return 1.0
        lost = self.wasted_chip_s + self.checkpoint_overhead_chip_s
        return max(1.0 - lost / total, 0.0)

    @property
    def checkpoint_overhead_chip_s(self) -> float:
        return self.extras.get("ckpt_overhead_chip_s", 0.0)

    @property
    def _busy_chip_s(self) -> float:
        return self.extras.get("busy_chip_s", 0.0)

    def summary(self) -> str:
        """One human-readable block (RAPS prints the same shape)."""
        return (
            f"jobs      {self.jobs_completed}/{self.jobs_submitted} completed"
            f" ({self.requeues} requeues, {self.jobs_dropped} dropped)\n"
            f"failures  {self.node_failures} node failures, "
            f"{self.node_downtime_s / 3600.0:.1f} node-hours down\n"
            f"waste     {self.wasted_node_s / 3600.0:.2f} node-hours "
            f"redone ({self.wasted_energy_j / 3.6e6:.2f} kWh)   "
            f"goodput {self.goodput:.1%}\n"
            f"ckpt      {self.checkpoints} writes, "
            f"{self.checkpoint_overhead_s:.0f} s paused, "
            f"{self.checkpoint_energy_j / 3.6e6:.3f} kWh to storage\n"
            f"makespan  {self.makespan_s / 3600.0:.2f} h   "
            f"utilization {self.utilization:.1%}   "
            f"peak queue {self.queue_peak}\n"
            f"wait      mean {self.wait_mean_s:.0f} s, "
            f"p95 {self.wait_p95_s:.0f} s\n"
            f"energy    {self.energy_kwh:.1f} kWh "
            f"(avg {self.avg_power_w / 1e3:.2f} kW)   "
            f"cost ${self.cost_usd:.2f} @ ${self.usd_per_kwh:.2f}/kWh")


def compute_stats(records: Sequence[JobRecord],
                  placements: Sequence[Placement],
                  trace: PowerTrace,
                  topology: ClusterTopology, *,
                  node_failures: int = 0,
                  node_downtime_s: float = 0.0,
                  queue_peak: int = 0,
                  usd_per_kwh: float = DEFAULT_USD_PER_KWH,
                  wasted_chip_s: float = 0.0,
                  wasted_node_s: float = 0.0,
                  wasted_energy_j: float = 0.0,
                  checkpoints: int = 0,
                  checkpoint_overhead_s: float = 0.0,
                  checkpoint_overhead_chip_s: float = 0.0,
                  checkpoint_energy_j: float = 0.0) -> SimStats:
    """Fold the simulator's records into one :class:`SimStats` block.

    Utilization counts *committed* chip-seconds (including work lost to
    a node failure — those chips did draw busy power) against
    ``n_chips × makespan``; waits are first-dispatch latencies over the
    jobs that started.  The wasted/checkpoint figures come from the
    simulator's per-attempt accounting
    (:mod:`repro_torch.cluster.resilience`)."""
    makespan = max((p.end for p in placements), default=0.0)
    busy = sum((p.end - p.start) * len(p.chips) for p in placements)
    cap = topology.n_chips * makespan
    waits = np.asarray([r.wait_s for r in records if r.wait_s is not None],
                       dtype=float)
    energy = trace.energy_j()
    duration = max(trace.duration, 1e-12)
    return SimStats(
        jobs_submitted=len(records),
        jobs_completed=sum(r.state == COMPLETED for r in records),
        jobs_dropped=sum(r.state == DROPPED for r in records),
        requeues=sum(r.requeues for r in records),
        node_failures=node_failures,
        node_downtime_s=node_downtime_s,
        makespan_s=makespan,
        utilization=busy / cap if cap > 0.0 else 0.0,
        wait_mean_s=float(np.mean(waits)) if waits.size else 0.0,
        wait_p95_s=float(np.percentile(waits, 95)) if waits.size else 0.0,
        queue_peak=queue_peak,
        energy_j=energy,
        avg_power_w=energy / duration,
        cost_usd=energy / 3.6e6 * usd_per_kwh,
        usd_per_kwh=usd_per_kwh,
        wasted_chip_s=wasted_chip_s,
        wasted_node_s=wasted_node_s,
        wasted_energy_j=wasted_energy_j,
        checkpoints=checkpoints,
        checkpoint_overhead_s=checkpoint_overhead_s,
        checkpoint_energy_j=checkpoint_energy_j,
        extras={"busy_chip_s": busy,
                "ckpt_overhead_chip_s": checkpoint_overhead_chip_s})
