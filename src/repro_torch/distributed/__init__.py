"""Distributed substrate of the port: the LM sharding rules, meshes and
placement (``sharding``), the collectives over a mesh's coordinates
(``collectives``), the lattice T-sharding mesh, the training loop's
fault bookkeeping and the node-failure model."""
from repro_torch.distributed.fault import (  # noqa: F401
    FaultPolicy,
    FaultTolerantLoop,
    StepHealth,
    WeibullFailureModel,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    LatticeMesh,
    gather_t_blocks,
    lattice_eo_specs,
    lattice_mesh,
    split_t_blocks,
)
