"""Unified power-telemetry engine of the port: a numpy copy of the JAX
package's ``repro.power``, with the TPU chip model replaced by a table of
the port's own chip, an NVIDIA H100 SXM.

Layered like ExaDigiT/RAPS: calibrated device models compose into a
node→rack→cluster simulation that any workload emits telemetry into and
every consumer (Green500 methodology, the HPL and LQCD entry points, the
cluster scheduler) reads from.

  :mod:`repro_torch.power.model`     calibrated electrical constants and
                                     curves (S9150, fan, throttle, H100)
  :mod:`repro_torch.power.layers`    GPU → node (host + 4×S9150 + fans +
                                     PSU curve) → rack → cluster
  :mod:`repro_torch.power.trace`     ``PowerTrace`` + ``TraceRecorder`` bus
  :mod:`repro_torch.power.engine`    ``simulate(workload, op) → PowerTrace``
  :mod:`repro_torch.power.green500`  L1/L2/L3 methodology over a trace

Quick use::

    from repro_torch.power import OperatingPoint, SyntheticHPL, simulate
    trace = simulate(SyntheticHPL(1800.0), OperatingPoint.green500())
    trace.avg_power()        # ≈ 57.2 kW + 257 W of switches
"""
from repro_torch.power.model import (  # noqa: F401
    EFFICIENT_MHZ,
    H100_SXM,
    HPL_GPU_UTIL,
    K_DYN,
    NB_EFFICIENCY,
    NB_PERFORMANCE,
    STOCK_MHZ,
    S9150,
    V_MAX,
    V_MIN,
    ChipTable,
    GPUSpec,
    H100ChipModel,
    OperatingPoint,
    PowerModel,
    fan_curve,
    fan_power,
    gpu_power,
    gpu_power_throttled,
    h100_chip_power,
    hpl_block_perf_scale,
    hpl_block_util,
    lookahead_perf_scale,
    sample_vids,
    sustained_frequency,
    temp_from_fan,
    voltage_at,
)
from repro_torch.power.layers import (  # noqa: F401
    LCSC_PSU,
    ClusterModel,
    GPUModel,
    NodeModel,
    NodePowerModel,
    PSUCurve,
    RackModel,
    lcsc_cluster,
    lcsc_node,
    node_power,
)
from repro_torch.power.trace import (  # noqa: F401
    NETWORK,
    PowerTrace,
    TraceRecorder,
)
from repro_torch.power.engine import (  # noqa: F401
    ConstantLoad,
    ReplayWorkload,
    SyntheticHPL,
    Workload,
    evaluate_operating_point,
    node_hpl_gflops,
    simulate,
)
from repro_torch.power.green500 import (  # noqa: F401
    LinpackTrace,
    MeasurementResult,
    extrapolation_error,
    level1_exploit,
    linpack_power_trace,
    measure_efficiency,
    node_efficiencies,
    select_median_nodes,
)
