from repro_torch.kernels.rmsnorm.kernel import (  # noqa: F401
    LAUNCHES,
    reset_launches,
)
from repro_torch.kernels.rmsnorm.ops import rmsnorm  # noqa: F401
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: F401
