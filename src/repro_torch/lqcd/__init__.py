"""Lattice QCD substrate of the PyTorch/CUDA port — the L-CSC cluster's
primary workload (paper C1).

Wilson-Dirac D-slash (the memory-bound hotspot), even-odd preconditioning,
and a conjugate-gradient solver for the Dirac equation, in PyTorch, on one
device or T-sharded over a ``repro_torch.distributed.LatticeMesh``, from
whole tensors or from per-shard T-slabs (``ShardedWilsonEO``,
``solve_dirac(..., mesh=)``, ``solve_wilson_eo_slabs``; the full-lattice
``dslash_sharded`` is in ``repro_torch.lqcd.multichip``).  The hand-written
CUDA D-slash kernels live in ``repro_torch.kernels.dslash``.
"""
from repro_torch.lqcd.su3 import random_su3_field, su3_project  # noqa: F401
from repro_torch.lqcd.dirac import (  # noqa: F401
    GAMMA,
    dslash,
    wilson_matvec,
    dslash_flops_per_site,
    dslash_bytes_per_site,
)
from repro_torch.lqcd.cg import (  # noqa: F401
    cg_solve,
    solve_dirac,
    solve_wilson,
    solve_wilson_eo,
)
from repro_torch.lqcd.eo import (  # noqa: F401
    dslash_half,
    eo_pack,
    eo_unpack,
    pack_gauge,
    schur_matvec,
)
from repro_torch.lqcd.multichip_eo import (  # noqa: F401
    LQCDCalibration,
    ShardedWilsonEO,
    analytic_lqcd_calibration,
    dslash_half_sharded,
    measured_lqcd_calibration,
)
