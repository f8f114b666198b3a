"""Model substrate of the port: the mamba2 (ssm) family."""
from repro_torch.models.transformer import (  # noqa: F401
    init_params,
    forward_prefill,
    forward_decode,
    init_decode_cache,
)
