"""Shape-and-dtype stand-ins for every model input (no allocation).

The JAX package's ``jax.ShapeDtypeStruct`` becomes a tensor on the
``meta`` device.  ``input_specs`` builds the training/prefill batch;
``decode_input_specs`` builds (tokens, cache) for one serve step against
a full KV/state cache, through ``init_decode_cache(..., device="meta")``,
so nothing is allocated even at the largest configuration's full width.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models import init_decode_cache
from repro_torch.models.frontend import enc_len_for
from repro_torch.models.layers import param_dtype


def _sds(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Batch stand-ins for train_step / prefill_step."""
    B, S = shape.global_batch, shape.seq_len
    dt = param_dtype(cfg)
    i32 = torch.int32
    batch: Dict[str, Any] = {}
    if cfg.family == "vlm":
        n_p = cfg.n_patches
        batch["tokens"] = _sds((B, S - n_p), i32)
        batch["patch_embeds"] = _sds((B, n_p, cfg.d_model), dt)
        if shape.kind == "train":
            batch["labels"] = _sds((B, S - n_p), i32)
    elif cfg.family == "encdec":
        batch["tokens"] = _sds((B, S), i32)
        batch["frame_embeds"] = _sds((B, enc_len_for(cfg, S), cfg.d_model),
                                     dt)
        if shape.kind == "train":
            batch["labels"] = _sds((B, S), i32)
    else:
        batch["tokens"] = _sds((B, S), i32)
        if shape.kind == "train":
            batch["labels"] = _sds((B, S), i32)
    return batch


KV_QUANT_THRESHOLD = 6 * 2**30      # per-chip bf16 cache bytes triggering int8


def should_quantize_kv(cfg: ModelConfig, shape: ShapeConfig,
                       n_devices: int = 256) -> bool:
    from repro_torch.models.transformer import kv_cache_bytes
    return (kv_cache_bytes(cfg, shape.global_batch, shape.seq_len)
            / n_devices > KV_QUANT_THRESHOLD)


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig,
                       quantize_kv_cache: bool = False,
                       ) -> Tuple[Any, Dict[str, Any]]:
    """(token, cache) stand-ins for one decode step at cache length S."""
    B, S = shape.global_batch, shape.seq_len
    tokens = _sds((B, 1), torch.int32)
    cache = init_decode_cache(cfg, B, S, quantize_kv_cache=quantize_kv_cache,
                              device="meta")
    return tokens, cache
