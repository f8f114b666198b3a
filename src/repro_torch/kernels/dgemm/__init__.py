from repro_torch.kernels.dgemm.kernel import (  # noqa: F401
    LAUNCHES,
    reset_launches,
)
from repro_torch.kernels.dgemm.ops import dgemm, dgemm_update_  # noqa: F401
from repro_torch.kernels.dgemm.ref import (  # noqa: F401
    dgemm_ref,
    dgemm_update_ref_,
)
