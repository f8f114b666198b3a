"""Shared layers: norms, token embeddings and the LM head.

Counterpart of the JAX package's ``repro/models/layers.py``.  Parameters
live in ``nn.Module``s whose attribute names are the JAX dict keys
(``scale``, ``bias``, ``tokens``, ``w``); the functions that use them are
plain functions on tensors.  RMSNorm runs the hand-written kernel on a
card (``kernels/rmsnorm``).  RoPE and the MLP variants come with the
attention and MLP families (ROADMAP A6).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels.rmsnorm import rmsnorm


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter for serving: no gradient is kept for it."""
    return nn.Parameter(t, requires_grad=False)


def normal(shape, scale: float, dtype: torch.dtype, device,
           generator: torch.Generator | None) -> torch.Tensor:
    """``normal(0, 1) * scale`` drawn in float32, then cast to ``dtype``,
    as the JAX package's initialisers do."""
    t = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (t * scale).to(dtype)


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """``scale`` (d,) for rmsnorm and layernorm, ``bias`` (d,) for
    layernorm; no parameters for nonparametric_ln."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if cfg.norm_variant == "nonparametric_ln":
            return
        d, dt = cfg.d_model, param_dtype(cfg)
        self.scale = frozen(torch.ones(d, dtype=dt, device=device))
        if cfg.norm_variant == "layernorm":
            self.bias = frozen(torch.zeros(d, dtype=dt, device=device))


def init_norm(cfg: ModelConfig, device="cuda") -> Norm:
    return Norm(cfg, device)


def apply_norm(cfg: ModelConfig, p: Norm, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm (eps 1e-6) or LayerNorm (eps 1e-5) over the last dim, in
    float32 math, returned in ``x.dtype``."""
    if cfg.norm_variant == "rmsnorm":
        return rmsnorm(x, p.scale, eps=1e-6)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + 1e-5)
    if cfg.norm_variant == "layernorm":
        y = y * p.scale.float() + p.bias.float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """``tokens`` (vocab_padded, d_model)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.tokens = frozen(torch.empty(cfg.vocab_padded, cfg.d_model,
                                         dtype=param_dtype(cfg),
                                         device=device))


def init_embedding(cfg: ModelConfig, generator: torch.Generator | None,
                   device="cuda") -> Embedding:
    p = Embedding(cfg, device)
    p.tokens.copy_(normal(p.tokens.shape, 1.0 / math.sqrt(cfg.d_model),
                          p.tokens.dtype, device, generator))
    return p


def embed_tokens(p: Embedding, tokens: torch.Tensor) -> torch.Tensor:
    return p.tokens[tokens]


class LMHead(nn.Module):
    """``w`` (d_model, vocab_padded); no parameters with tied embeddings."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        if not cfg.tie_embeddings:
            self.w = frozen(torch.empty(cfg.d_model, cfg.vocab_padded,
                                        dtype=param_dtype(cfg),
                                        device=device))


def init_lm_head(cfg: ModelConfig, generator: torch.Generator | None,
                 device="cuda") -> LMHead:
    p = LMHead(cfg, device)
    if not cfg.tie_embeddings:
        p.w.copy_(normal(p.w.shape, 1.0 / math.sqrt(cfg.d_model), p.w.dtype,
                         device, generator))
    return p


def lm_head_logits(cfg: ModelConfig, embed_p: Embedding, head_p: LMHead,
                   x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's dtype, the padded vocab tail set to -1e30."""
    w = embed_p.tokens.T if cfg.tie_embeddings else head_p.w
    logits = torch.matmul(x, w)
    if cfg.vocab_padded != cfg.vocab_size:
        # mask the padded vocab tail so it carries no probability mass
        valid = torch.arange(cfg.vocab_padded,
                             device=logits.device) < cfg.vocab_size
        logits = torch.where(valid, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=logits.device))
    return logits
