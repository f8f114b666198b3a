"""HPL (Linpack): the paper's section 2 benchmark, as blocked LU."""
from repro_torch.hpl.lu import blocked_lu, lu_solve  # noqa: F401
from repro_torch.hpl.linpack import linpack_run, linpack_residual  # noqa: F401
