"""Seeds of the benchmark's inputs, drawn from ``--seed`` and the index
of the input (a source, a matrix).  Any whole number goes in, however
large; what comes out fits ``torch.Generator.manual_seed``."""
from __future__ import annotations

import numpy as np


def mix(seed: int, *index: int) -> int:
    """A 63-bit seed for input ``index`` of the run seeded ``seed``.
    Negative indices (warm-up inputs) are kept apart from the window's."""
    words = [abs(int(seed)), int(seed < 0)]
    for i in index:
        words += [abs(int(i)), int(i < 0)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])
