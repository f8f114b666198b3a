"""Serve-traffic replay of the port: recorded-request traces, continuous
batching, per-request J/token accounting, SLO-aware autoscaling, and the
executed-group runtime that runs the model's steps on the card.

A copy of the JAX package's ``repro.serve``; its watts and rates are an
H100 SXM's (``chip=``) where the JAX package reads its TPU constants.
"""
from repro_torch.serve.autoscale import (HOST_SHARE_W, AutoscalePolicy,
                                         FleetResult, RetryPolicy, flat_out,
                                         run_fleet)
from repro_torch.serve.engine import (ContinuousBatchingEngine, Replica,
                                      RequestRecord, ServeCostModel,
                                      ServeResult, emit_step_intervals)
from repro_torch.serve.executed import ExecutedGroupRuntime
from repro_torch.serve.replay import ReplayServeWorkload, replay_shards
from repro_torch.serve.stats import (ServeStats, compute_serve_stats,
                                     request_energy_j, step_window_integral)
from repro_torch.serve.trace import (RequestTrace, constant_trace,
                                     diurnal_trace, poisson_trace)

__all__ = [
    "AutoscalePolicy", "ContinuousBatchingEngine", "ExecutedGroupRuntime",
    "FleetResult",
    "HOST_SHARE_W", "Replica", "ReplayServeWorkload", "RequestRecord",
    "RequestTrace", "RetryPolicy", "ServeCostModel", "ServeResult",
    "ServeStats",
    "compute_serve_stats", "constant_trace", "diurnal_trace",
    "emit_step_intervals", "flat_out", "poisson_trace",
    "replay_shards", "request_energy_j", "run_fleet",
    "step_window_integral",
]
