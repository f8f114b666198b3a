"""Checkpoint/restart of the port, in the JAX package's on-disk format."""
from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointError,
    CheckpointManager,
)
