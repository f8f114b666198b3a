"""The run's process must hold neither JAX nor the JAX package.  A
module's top-level name (the part before the first dot) is compared
whole: ``repro_torch`` is the port, ``repro`` the reference package."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(names=None) -> list[str]:
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)
