"""Modality frontend stubs (a copy of the JAX package's
``models/frontend.py``, the sequence arithmetic only).

The audio (whisper) and vlm (llava) projections, ``init_frontend`` and
``apply_frontend``, come with those families (ROADMAP A6).
"""
from __future__ import annotations

from repro_torch.config import ModelConfig


def enc_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Audio stub: conv frontend downsamples dec_len by encoder_ratio."""
    return max(1, seq_len // cfg.encoder_ratio)
