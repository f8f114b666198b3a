"""The decoder stack, for the ``ssm`` family (mamba2).

Counterpart of the JAX package's ``repro/models/transformer.py``.  Layers
run in a Python loop where the JAX package scans over stacked layer
parameters; the decode cache keeps the JAX package's stacked keys and
layouts, so the two packages' caches compare directly:

  ssm:  (L, B, H, P, N) float32
  conv: (L, B, K-1, conv_ch) in the model's dtype
  pos:  int32 scalar

Every other family raises ``NotImplementedError`` (ROADMAP A6).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Embedding, LMHead, Norm, apply_norm,
                                       embed_tokens, init_embedding,
                                       init_lm_head, init_norm,
                                       lm_head_logits, param_dtype)


def _require_ssm(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"the port runs the ssm family only, not {cfg.family!r} "
            f"({cfg.name}): ROADMAP A6 (attention, MLP and MoE families)")


class DecoderLayer(nn.Module):
    """One mamba2 layer: ``norm1`` and ``ssm``."""

    def __init__(self, norm1: Norm, ssm: ssm_mod.SSM):
        super().__init__()
        self.norm1 = norm1
        self.ssm = ssm


class Model(nn.Module):
    """``embed``, ``layers`` (one ``DecoderLayer`` each), ``final_norm`` and
    ``lm_head``: the JAX package's parameter tree, its layer axis
    unstacked."""

    def __init__(self, embed: Embedding, layers, final_norm: Norm,
                 lm_head: LMHead):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = lm_head


def empty_params(cfg: ModelConfig, device="cuda") -> Model:
    """The model with its parameters allocated, not initialised."""
    _require_ssm(cfg)
    dev = resolve_device(device)
    return Model(Embedding(cfg, dev),
                 [DecoderLayer(Norm(cfg, dev), ssm_mod.SSM(cfg, dev))
                  for _ in range(cfg.n_layers)],
                 Norm(cfg, dev), LMHead(cfg, dev))


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> Model:
    """Random weights, drawn as the JAX package draws them (normals scaled
    and cast to the model's dtype) but from ``generator``, a
    ``torch.Generator`` on ``device``: the numbers differ from the JAX
    package's.  Tests carry JAX weights over with
    ``convert.params_from_numpy`` instead."""
    _require_ssm(cfg)
    dev = resolve_device(device)
    layers = [DecoderLayer(init_norm(cfg, dev),
                           ssm_mod.init_ssm(cfg, generator, dev))
              for _ in range(cfg.n_layers)]
    return Model(init_embedding(cfg, generator, dev), layers,
                 init_norm(cfg, dev), init_lm_head(cfg, generator, dev))


# ---------------------------------------------------------------------------
# Full-model forward (prefill)
# ---------------------------------------------------------------------------

def forward_hidden(cfg: ModelConfig, params: Model, batch, *,
                   want_cache: bool = False):
    """Embed + all decoder layers + the final norm.  Returns
    (hidden (B, S, D), cache dict of stacked ``ssm``/``conv`` or None)."""
    _require_ssm(cfg)
    x = embed_tokens(params.embed, batch["tokens"])
    hs, convs = [], []
    for layer in params.layers:
        h = apply_norm(cfg, layer.norm1, x)
        out, (hT, conv) = ssm_mod.ssm_forward(cfg, layer.ssm, h)
        x = x + out
        if want_cache:
            hs.append(hT)
            convs.append(conv)
    x = apply_norm(cfg, params.final_norm, x)
    caches = ({"ssm": torch.stack(hs), "conv": torch.stack(convs)}
              if want_cache else None)
    return x, caches


def forward_prefill(cfg: ModelConfig, params: Model, batch):
    """Returns (last-token logits (B, V), decode cache dict)."""
    hidden, cache = forward_hidden(cfg, params, batch, want_cache=True)
    logits = lm_head_logits(cfg, params.embed, params.lm_head, hidden[:, -1])
    cache["pos"] = torch.tensor(hidden.shape[1], dtype=torch.int32,
                                device=hidden.device)
    return logits, cache


# ---------------------------------------------------------------------------
# Serving: decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
                      dtype: torch.dtype | None = None,
                      device="cuda") -> dict:
    """Zero cache for ``batch_size`` sequences.  An SSM's state does not
    grow with the sequence, so ``max_seq`` does not change its shape."""
    _require_ssm(cfg)
    dev = resolve_device(device)
    dt = dtype or param_dtype(cfg)
    L = cfg.n_layers
    _, n_heads, conv_ch = ssm_mod.ssm_dims(cfg)
    return {
        "pos": torch.tensor(0, dtype=torch.int32, device=dev),
        "ssm": torch.zeros((L, batch_size, n_heads, cfg.ssm.head_dim,
                            cfg.ssm.d_state), dtype=torch.float32,
                           device=dev),
        "conv": torch.zeros((L, batch_size, cfg.ssm.d_conv - 1, conv_ch),
                            dtype=dt, device=dev),
    }


def forward_decode(cfg: ModelConfig, params: Model, tokens: torch.Tensor,
                   cache: dict):
    """One decode step.  tokens: (B, 1) integer.  Returns (logits (B, V),
    new cache); the cache passed in is not modified."""
    _require_ssm(cfg)
    x = embed_tokens(params.embed, tokens)
    new_ssm = torch.empty_like(cache["ssm"])
    new_conv = torch.empty_like(cache["conv"])
    for l, layer in enumerate(params.layers):
        h = apply_norm(cfg, layer.norm1, x)
        out, new_ssm[l], new_conv[l] = ssm_mod.ssm_decode(
            cfg, layer.ssm, h, cache["ssm"][l], cache["conv"][l])
        x = x + out
    x = apply_norm(cfg, params.final_norm, x)
    logits = lm_head_logits(cfg, params.embed, params.lm_head, x[:, 0])
    return logits, {"pos": cache["pos"] + 1, "ssm": new_ssm,
                    "conv": new_conv}
