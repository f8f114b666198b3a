"""Learning-rate schedules: the counterpart of the JAX package's
``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch

from repro_torch.config import TrainConfig


def lr_schedule(step: torch.Tensor, tc: TrainConfig) -> torch.Tensor:
    """Linear warmup + cosine decay to 10%, in float32 on ``step``'s
    device.  ``step`` is the number of updates made so far, so the first
    update's rate is 0 whatever ``warmup_steps`` is, as in the
    reference."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(tc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(tc.total_steps - tc.warmup_steps, 1), 0, 1)
    cos = 0.1 + 0.45 * (1 + torch.cos(math.pi * prog))
    return tc.learning_rate * warm * cos
