from repro_torch.kernels.ssd_chunk.kernel import (  # noqa: F401
    LAUNCHES,
    reset_launches,
)
from repro_torch.kernels.ssd_chunk.ops import ssd_chunk  # noqa: F401
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref  # noqa: F401
