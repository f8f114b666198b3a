"""Checkpoint/restart resilience: Daly-interval scheduling + wasted-work
accounting for the online cluster simulator (a copy of the JAX
package's ``cluster/resilience.py``).

L-CSC is a commodity cluster, so node failure is an operating
assumption — and because the whole project optimizes *energy to
solution*, every joule burned on a killed attempt that restarts from
zero is a direct MFLOPS/W hit.  This module gives the discrete-event
simulator (:mod:`repro_torch.cluster.sim`) the policy layer that bounds that
waste:

  * :class:`CheckpointPolicy` derives the Young/Daly first-order
    optimal checkpoint interval ``τ* = √(2·δ·MTBF)`` from the shared
    :class:`repro_torch.distributed.fault.WeibullFailureModel` and a
    per-workload checkpoint cost model — state bytes from the
    ``Workload`` protocol's ``state_bytes()`` surface (or the job's
    resident working set), write time ``δ`` from a storage-bandwidth
    constant, write *energy* from a storage-subsystem power constant
    that the simulator emits onto the telemetry bus as its own
    ``storage`` component, so checkpoint overhead shows up in the
    Green500 L1/L2/L3 numbers honestly;
  * :class:`AttemptPlan` is one placement attempt's checkpoint
    schedule: ``work_s`` seconds of compute with a ``δ``-second write
    pause after every ``τ`` seconds of work (never one at the very
    end).  It answers the three questions the event loop asks — how
    long does this attempt run (:attr:`duration_s`), how much progress
    survives a kill ``e`` seconds in (:meth:`progress_at`, rounded
    *down* to the last completed checkpoint), and which write windows
    actually burned storage power (:meth:`checkpoint_windows`).

With no failure model the MTBF is infinite, ``τ* = ∞`` and zero
checkpoints are scheduled — the no-failure oracle path stays
bit-identical to batch ``cluster.run()``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

#: node-local checkpoint storage write bandwidth [bytes/s] — the
#: paper-era commodity SATA-SSD/RAID figure (≈1 GB/s per node)
DEFAULT_STORAGE_BW_BS = 1.0e9

#: extra node power while a checkpoint streams to storage [W] — drives
#: + controller burst draw, billed as the trace's ``storage`` component
DEFAULT_WRITE_W = 25.0


def job_state_bytes(job) -> float:
    """Checkpointable state for a job spec: an explicit
    ``Job.state_bytes`` (set by a ``Workload.state_bytes()`` adapter)
    wins — including an explicit ``0.0``, which marks the workload
    *stateless* (serving: KV cache is reconstructible) and disables
    checkpointing for it.  Otherwise the resident working set
    (``mem_gb``) is the honest upper bound — HPL's factored matrix and
    an LQCD gauge+spinor set both live GPU-resident."""
    sb = getattr(job, "state_bytes", None)
    if sb is not None:
        return float(sb)
    return float(job.mem_gb) * 1e9


def daly_interval_s(delta_s: float, mtbf_s: float) -> float:
    """Young/Daly first-order optimal checkpoint interval
    ``√(2·δ·MTBF)`` — infinite (checkpointing off) when the MTBF is
    infinite or the write is free."""
    if not math.isfinite(mtbf_s) or mtbf_s <= 0.0 or delta_s <= 0.0:
        return math.inf
    return math.sqrt(2.0 * delta_s * mtbf_s)


@dataclass(frozen=True)
class CheckpointPolicy:
    """When and at what cost a running placement checkpoints.

    ``interval_s=None`` (the default) derives the per-attempt Daly
    interval from the failure model's MTBF at the placement's node
    span; a fixed override models naive operator-chosen intervals (the
    benchmark's sweep).  ``min_interval_s`` floors pathological
    always-checkpointing regimes."""

    storage_bw_bs: float = DEFAULT_STORAGE_BW_BS
    write_w: float = DEFAULT_WRITE_W
    interval_s: Optional[float] = None   # fixed override; None = Daly
    min_interval_s: float = 30.0

    def __post_init__(self):
        if self.storage_bw_bs <= 0.0 or self.write_w < 0.0:
            raise ValueError("storage_bw_bs must be positive, write_w "
                             "non-negative")
        if self.interval_s is not None and self.interval_s <= 0.0:
            raise ValueError("fixed interval_s must be positive")

    def write_time_s(self, job) -> float:
        """δ — seconds to stream the job's state to storage."""
        return job_state_bytes(job) / self.storage_bw_bs

    def interval_for(self, job, *, n_nodes: int = 1,
                     mtbf_node_s: float = math.inf) -> float:
        """The checkpoint interval for one attempt of ``job`` spanning
        ``n_nodes`` nodes.  A placement on ``n`` independent nodes
        fails at ``n×`` the per-node rate, so its effective MTBF is
        ``mtbf_node_s / n`` — wider shards checkpoint more often."""
        if self.interval_s is not None:
            return max(float(self.interval_s), self.min_interval_s)
        mtbf = mtbf_node_s / max(int(n_nodes), 1)
        tau = daly_interval_s(self.write_time_s(job), mtbf)
        return tau if not math.isfinite(tau) \
            else max(tau, self.min_interval_s)


@dataclass(frozen=True)
class AttemptPlan:
    """One placement attempt's checkpoint schedule.

    The attempt timeline alternates ``τ`` seconds of compute with a
    ``δ``-second write pause; checkpoint ``i`` *completes* at
    attempt-relative time ``i·(τ+δ)``.  No checkpoint is scheduled at
    the very end (finishing *is* the durable state), so an attempt with
    ``work_s ≤ τ`` runs checkpoint-free."""

    work_s: float                     # compute seconds this attempt owes
    tau_s: float                      # checkpoint interval (∞ = never)
    delta_s: float                    # per-checkpoint write time

    @property
    def n_checkpoints(self) -> int:
        if not math.isfinite(self.tau_s) or self.tau_s <= 0.0 \
                or self.work_s <= 0.0:
            return 0
        return max(int(math.ceil(self.work_s / self.tau_s - 1e-9)) - 1, 0)

    @property
    def overhead_s(self) -> float:
        """Wall seconds the attempt pauses for checkpoint writes."""
        return self.n_checkpoints * self.delta_s

    @property
    def duration_s(self) -> float:
        return self.work_s + self.overhead_s

    def checkpoint_windows(self, until_s: Optional[float] = None,
                           ) -> List[Tuple[float, float]]:
        """Attempt-relative ``(w_start, w_end)`` write windows.
        ``until_s`` (a kill time) clips the schedule: a write in
        progress at the kill is truncated — its energy was still burned
        and is still billed, but only *completed* writes preserve
        progress (:meth:`progress_at`)."""
        out: List[Tuple[float, float]] = []
        for i in range(1, self.n_checkpoints + 1):
            w0 = i * self.tau_s + (i - 1) * self.delta_s
            w1 = w0 + self.delta_s
            if until_s is not None:
                if w0 >= until_s:
                    break
                w1 = min(w1, until_s)
            if w1 > w0:
                out.append((w0, w1))
        return out

    def progress_at(self, elapsed_s: float) -> Tuple[float, float]:
        """``(preserved_s, wasted_s)`` when the attempt is killed
        ``elapsed_s`` in: compute seconds durably saved by the last
        *completed* checkpoint (rounded down — a write in progress
        saves nothing), and compute seconds executed since it (redone
        work, the waste :class:`repro_torch.cluster.stats.SimStats` surfaces).
        """
        e = min(max(elapsed_s, 0.0), self.duration_s)
        if self.n_checkpoints == 0:
            return 0.0, min(e, self.work_s)
        cycle = self.tau_s + self.delta_s
        k = min(int(e // cycle), self.n_checkpoints)
        rem = max(e - k * cycle, 0.0)
        executed = min(k * self.tau_s + min(rem, self.tau_s), self.work_s)
        preserved = k * self.tau_s
        return preserved, max(executed - preserved, 0.0)
