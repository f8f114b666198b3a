"""Optimizers of the port: AdamW and its learning-rate schedule."""
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.schedule import lr_schedule  # noqa: F401
