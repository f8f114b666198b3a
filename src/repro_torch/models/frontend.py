"""Modality frontend stubs (counterpart of the JAX package's
``models/frontend.py``).

``[audio]`` (whisper) and ``[vlm]`` (llava) entries specify the transformer
backbone only; the caller provides precomputed frame or patch embeddings.
What is kept is the learnable glue: a projection of those embeddings into
the backbone width (llava's mm-projector; whisper's post-conv linear),
plus sinusoidal positions for the audio encoder.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.layers import frozen, normal, param_dtype


def enc_len_for(cfg: ModelConfig, seq_len: int) -> int:
    """Audio stub: conv frontend downsamples dec_len by encoder_ratio."""
    return max(1, seq_len // cfg.encoder_ratio)


class Frontend(nn.Module):
    """``proj_w`` (d, d) and ``proj_b`` (d,)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        d, dt = cfg.d_model, param_dtype(cfg)
        self.proj_w = frozen(torch.empty(d, d, dtype=dt, device=device))
        self.proj_b = frozen(torch.empty(d, dtype=dt, device=device))


def init_frontend(cfg: ModelConfig, generator: torch.Generator | None,
                  device="cuda") -> Frontend:
    p = Frontend(cfg, device)
    p.proj_w.copy_(normal(p.proj_w.shape, 0.02, p.proj_w.dtype, device,
                          generator))
    p.proj_b.zero_()
    return p


def apply_frontend(cfg: ModelConfig, p: Frontend,
                   embeds: torch.Tensor) -> torch.Tensor:
    """Project precomputed frame/patch embeddings (B, S, d) into the
    backbone, in the promoted dtype of the embeddings and the weights (as
    ``jnp.einsum`` promotes)."""
    dt = torch.promote_types(embeds.dtype, p.proj_w.dtype)
    return torch.matmul(embeds.to(dt), p.proj_w.to(dt)) + p.proj_b.to(dt)


def sinusoidal_positions(length: int, d_model: int,
                         device=None) -> torch.Tensor:
    """(length, d_model) float32: sin on the even columns, cos on the
    odd."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=device)[None, :]
    ang = pos / torch.pow(10_000.0, dim / d_model)
    pe = torch.zeros((length, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang[:, : (d_model - d_model // 2)])
    return pe
