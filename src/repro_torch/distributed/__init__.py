"""Distributed substrate of the port: the lattice T-sharding mesh and the
node-failure model."""
from repro_torch.distributed.fault import WeibullFailureModel  # noqa: F401
from repro_torch.distributed.sharding import (  # noqa: F401
    LatticeMesh,
    gather_t_blocks,
    lattice_eo_specs,
    lattice_mesh,
    split_t_blocks,
)
