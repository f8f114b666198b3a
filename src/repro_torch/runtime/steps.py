"""Step functions: train (forward, backward, AdamW), prefill and decode.

Counterpart of the JAX package's ``repro/runtime/steps.py`` on one
device.  The ``make_*`` functions return plain callables; there is no
``jit`` and no mesh.  The serve steps run under ``torch.inference_mode``.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.models import (forward_decode, forward_prefill,
                                forward_train_loss, init_decode_cache)
from repro_torch.optim import adamw_update, lr_schedule


def loss_and_grads(cfg: ModelConfig, tc: TrainConfig, params, batch, *,
                   block_skip: bool = False):
    """One batch's training loss under ``tc``'s remat policy, and its
    gradients: (loss, {"lm_loss", "aux_loss"}, {name: gradient}), all
    detached, each gradient in its parameter's dtype (zeros where the
    loss does not reach a parameter).  ``params`` must require
    gradients (``params.requires_grad_()``)."""
    names, leaves = zip(*params.named_parameters())
    loss, metrics = forward_train_loss(
        cfg, params, batch, remat=tc.remat != "none", block_skip=block_skip,
        remat_policy=tc.remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        k: torch.zeros_like(p) if g is None else g
        for k, p, g in zip(names, leaves, grads)}


def make_train_step(cfg: ModelConfig, tc: TrainConfig,
                    block_skip: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the reference's one-device ``make_train_step``.

    ``params`` is the model (made to require gradients) and ``opt_state``
    ``adamw_init``'s dict, both updated in place and returned; ``batch``
    holds tensors on the model's device whose rows split into
    ``tc.microbatches`` equal microbatches.  ``metrics`` holds ``loss``, ``lm_loss``, ``aux_loss``,
    ``grad_norm`` and ``lr`` as 0-d device tensors: the step reads
    nothing back to the host.  As in the reference, with one microbatch
    the gradients stay in the parameters' dtypes; with M > 1 each
    microbatch's are cast to ``grad_accum_dtype`` and summed in order,
    then divided by M, and ``lm_loss`` is the mean total loss (aux
    included) and ``aux_loss`` zero."""
    gdt = getattr(torch, tc.grad_accum_dtype)

    def train_step(params, opt_state, batch):
        params.requires_grad_()
        M = tc.microbatches
        if M == 1:
            loss, metrics, grads = loss_and_grads(cfg, tc, params, batch,
                                                  block_skip=block_skip)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % M:
                raise ValueError(f"a batch of {rows} rows does not split "
                                 f"into {M} microbatches")
            n = rows // M
            grads = {k: torch.zeros(p.shape, dtype=gdt, device=p.device)
                     for k, p in params.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(grads.values())).device)
            for i in range(M):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss_i, _, g = loss_and_grads(cfg, tc, params, mb,
                                              block_skip=block_skip)
                for k, acc in grads.items():
                    acc.add_(g[k].to(gdt))
                loss = loss + loss_i
                del g       # before the next microbatch's backward
            grads = {k: acc / M for k, acc in grads.items()}
            loss = loss / M
            metrics = {"lm_loss": loss,
                       "aux_loss": torch.zeros_like(loss)}
        lr = lr_schedule(opt_state["step"], tc)
        params, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                                lr, tc)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return train_step


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
