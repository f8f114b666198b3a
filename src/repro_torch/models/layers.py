"""Shared layers: norms, token embeddings, the LM head, RoPE and the MLP
variants.

Counterpart of the JAX package's ``repro/models/layers.py``.  Parameters
live in ``nn.Module``s whose attribute names are the JAX dict keys
(``scale``, ``bias``, ``tokens``, ``w``, ``w_gate``, ``w_up``,
``w_down``); the functions that use them are plain functions on tensors.
RMSNorm runs the hand-written kernel on a card (``kernels/rmsnorm``);
RoPE and the MLPs are plain PyTorch, as the reference's are plain jnp.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels.rmsnorm import rmsnorm


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter for serving: no gradient is kept for it
    (``model.requires_grad_()`` makes a model trainable; the train step
    does so)."""
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


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, d_head); positions: (S,) or broadcastable to
    x[..., :, 0].  Rotates the two halves of the head in float32 and
    returns x's dtype."""
    inv = rope_freqs(x.shape[-1], theta, x.device)         # (d_head/2,)
    ang = positions[..., :, None].float() * inv              # (..., S, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP variants
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    """``w_gate``, ``w_up`` (d, f) and ``w_down`` (f, d) for swiglu and
    geglu; ``w_up`` and ``w_down`` for relu2 and gelu."""

    def __init__(self, cfg: ModelConfig, device="cuda",
                 d_ff: int | None = None):
        super().__init__()
        d, f, dt = cfg.d_model, d_ff or cfg.d_ff, param_dtype(cfg)

        def empty(*shape):
            return frozen(torch.empty(shape, dtype=dt, device=device))

        if cfg.mlp_variant in ("swiglu", "geglu"):
            self.w_gate = empty(d, f)
        self.w_up = empty(d, f)
        self.w_down = empty(f, d)


def init_mlp(cfg: ModelConfig, generator: torch.Generator | None,
             device="cuda", d_ff: int | None = None) -> MLP:
    p = MLP(cfg, device, d_ff)
    s_in, s_out = 0.02, 0.02 / math.sqrt(2.0 * cfg.n_layers)
    for name, t in p.named_parameters():
        t.copy_(normal(t.shape, s_out if name == "w_down" else s_in,
                       t.dtype, device, generator))
    return p


def apply_mlp(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_variant in ("swiglu", "geglu"):
        gate = torch.matmul(x, p.w_gate)
        up = torch.matmul(x, p.w_up)
        act = F.silu(gate) if cfg.mlp_variant == "swiglu" else gelu(gate)
        h = act * up
    else:
        h = torch.matmul(x, p.w_up)
        if cfg.mlp_variant == "relu2":
            h = torch.square(F.relu(h))
        else:  # gelu
            h = gelu(h)
    return torch.matmul(h, p.w_down)
