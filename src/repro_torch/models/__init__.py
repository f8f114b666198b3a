"""Model substrate of the port: every family's serve path (the train loss
comes with the train step, ROADMAP A6)."""
from repro_torch.models.transformer import (  # noqa: F401
    init_params,
    forward_prefill,
    forward_decode,
    init_decode_cache,
)
