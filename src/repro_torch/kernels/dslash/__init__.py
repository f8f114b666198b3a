from repro_torch.kernels.dslash.kernel import (  # noqa: F401
    LAUNCHES,
    dslash_eo_split,
    dslash_split,
    reset_launches,
)
from repro_torch.kernels.dslash.ops import (  # noqa: F401
    dslash_half_op,
    dslash_op,
)
from repro_torch.kernels.dslash.ref import (  # noqa: F401
    dslash_eo_split_ref,
    dslash_split_ref,
    from_split,
    to_split,
)
