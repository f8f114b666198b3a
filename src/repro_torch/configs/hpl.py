"""HPL (Linpack) benchmark configuration: the paper's section 2 workload.

A copy of the JAX package's ``HPLConfig``
(``src/repro/configs/hpl.py:10-39``): the port keeps its own so that it
imports nothing of the reference package.  It mirrors HPL-GPU's two
operating modes, ``performance`` and ``efficiency`` (the efficiency mode
gives up a little performance for lower power, paper section 2).
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class HPLConfig:
    n: int = 1024                 # matrix size (CPU-scale default)
    block: int = 128              # panel/update block size NB
    lookahead: int = 1            # lookahead depth (HPL-GPU style)
    mode: str = "performance"     # performance | efficiency
    dtype: str = "float32"
    seed: int = 7

    def efficiency(self) -> "HPLConfig":
        # Efficiency mode: smaller update tiles keep the chip below the
        # throttle point; paired with the DVFS plan's derated clock.
        return HPLConfig(n=self.n, block=max(32, self.block // 2),
                         lookahead=self.lookahead, mode="efficiency",
                         dtype=self.dtype, seed=self.seed)

    def tuned(self, device="cuda") -> "HPLConfig":
        """Blocking/lookahead from the autotune cache for this problem
        size and ``device`` (``repro_torch.autotune``; the analytic
        searcher runs once on a cache miss) — replaces the hard-coded
        block constants.  The caller's mode, dtype and seed are kept."""
        from repro_torch.autotune import tuned_config
        best = tuned_config("hpl", (self.n,), device=device)
        return HPLConfig(n=self.n, block=int(best["block"]),
                         lookahead=int(best["lookahead"]),
                         mode=self.mode, dtype=self.dtype,
                         seed=self.seed)


SMOKE_HPL = HPLConfig(n=192, block=32)
DEFAULT_HPL = HPLConfig()
