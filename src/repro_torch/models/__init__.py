"""Model substrate of the port: every family's train loss and serve
path."""
from repro_torch.models.transformer import (  # noqa: F401
    init_params,
    forward_prefill,
    forward_decode,
    init_decode_cache,
    forward_train_loss,
)
