"""Energy core of the port: the throttle performance curves, the DVFS
planner and the solver energy-to-solution model, with re-exports of the
power engine's names that the JAX package's ``repro.core.energy`` offers.
The JAX package's deprecated shim modules (``power_model``, ``green500``,
``scheduler``) are not copied."""
from repro_torch.power.model import (  # noqa: F401
    S9150,
    fan_power,
    gpu_power,
    voltage_at,
)
from repro_torch.power.layers import NodePowerModel, node_power  # noqa: F401
from repro_torch.core.energy.throttle import (  # noqa: F401
    dgemm_perf_gflops,
    hpl_node_perf,
    sustained_frequency,
)
from repro_torch.core.energy.dvfs import FreqPlan, plan_frequency  # noqa: F401
from repro_torch.power.green500 import (  # noqa: F401
    LinpackTrace,
    level1_exploit,
    linpack_power_trace,
    measure_efficiency,
)
from repro_torch.power.trace import PowerTrace  # noqa: F401
from repro_torch.core.energy.solver_energy import (  # noqa: F401
    H100_HW,
    S9150_HW,
    SolverEnergyReport,
    SolverHW,
    solver_energy,
)
