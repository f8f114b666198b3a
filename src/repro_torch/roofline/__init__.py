"""Roofline of the port: the device's constants (``hw``), the analytic
per-step cost model (``analytic``), the three-term roofline of a step
traced on ``meta`` tensors (``analysis``) and the dry run's table
(``report``).

``analysis``' names are exported lazily: ``power.model`` imports ``hw``
from this package, and ``analysis`` imports ``power.model``.
"""
_ANALYSIS = ("RooflineTerms", "analyze", "collective_stats", "model_flops",
             "traced_cost")
__all__ = list(_ANALYSIS)


def __getattr__(name):
    if name in _ANALYSIS:
        from repro_torch.roofline import analysis
        return getattr(analysis, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
