"""Step functions for serving: prefill and decode.

Counterpart of the JAX package's ``repro/runtime/steps.py`` (less the
train step, which comes with the backward kernels: ROADMAP A6).  The
``make_*`` functions return plain callables that run under
``torch.inference_mode``; there is no ``jit`` and no mesh.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import (forward_decode, forward_prefill,
                                init_decode_cache)


def make_prefill_step(cfg: ModelConfig, block_skip: bool = False,
                      quantize_kv_cache: bool = False):
    @torch.inference_mode()
    def prefill_step(params, batch):
        return forward_prefill(cfg, params, batch, block_skip=block_skip,
                               quantize_kv_cache=quantize_kv_cache)

    return prefill_step


def grow_decode_cache(cfg: ModelConfig, cache: dict, batch_size: int,
                      total_len: int, *,
                      dtype: torch.dtype | None = None,
                      quantize_kv_cache: bool = False) -> dict:
    """Grow a prefill-sized decode cache to ``total_len`` positions.

    Allocates a fresh full-length cache through ``init_decode_cache`` and
    copies the prefilled entries into its leading slice (``pos`` moves
    verbatim; entries whose shape does not depend on the length, such as
    SSM states, move as they are).  ``quantize_kv_cache`` makes the int8
    K/V cache that an int8 prefill cache grows into."""
    full = init_decode_cache(cfg, batch_size, total_len, dtype=dtype,
                             quantize_kv_cache=quantize_kv_cache,
                             device=cache["pos"].device)
    for k in cache:
        if k == "pos" or full[k].shape == cache[k].shape:
            full[k] = cache[k]
        else:
            full[k][tuple(slice(0, s) for s in cache[k].shape)] = cache[k]
    return full


def make_decode_step(cfg: ModelConfig):
    @torch.inference_mode()
    def decode_step(params, tokens, cache):
        return forward_decode(cfg, params, tokens, cache)

    return decode_step
