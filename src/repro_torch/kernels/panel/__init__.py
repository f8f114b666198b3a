from repro_torch.kernels.panel.kernel import (  # noqa: F401
    LAUNCHES,
    laswp_,
    panel_lu_,
    reset_launches,
)
