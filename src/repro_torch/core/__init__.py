"""The paper's energy machinery in the port (``core.energy``): throttle
performance curves, DVFS planning and the solver energy model.  The LQCD
application lives in ``repro_torch.lqcd``, HPL in ``repro_torch.hpl``."""
