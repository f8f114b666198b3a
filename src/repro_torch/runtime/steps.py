"""Step functions: train (forward, backward, AdamW), prefill and decode.

Counterpart of the JAX package's ``repro/runtime/steps.py``.  The
``make_*`` functions return plain callables; there is no ``jit``.  The
serve steps run under ``torch.inference_mode``.

With ``mesh`` (an ``LMMesh``) and ``mesh_cfg``, the model runs the
reference's per-shard bodies over the mesh (``models.transformer``), and
the steps take parameters placed by ``distributed.sharding.shard_tree``:
``{parameter name: ShardedTensor}`` (a port ``Model`` is taken too).  A
step gathers each parameter whole onto the mesh's first device and runs
the model through it (``torch.func.functional_call`` on a ``meta``
skeleton); the train step's gradients flow back through the gather onto
each parameter's shards, and AdamW updates the shards in place.
Batches and caches may be whole tensors or ``ShardedTensor``\\ s
(``batch_pspecs``, ``cache_pspecs``); caches come back whole.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from repro_torch.config import MeshConfig, ModelConfig, TrainConfig
from repro_torch.distributed.sharding import ShardedTensor, unshard_tensor
from repro_torch.models import (forward_decode, forward_prefill,
                                forward_train_loss, init_decode_cache)
from repro_torch.models.transformer import empty_params
from repro_torch.optim import adamw_update, lr_schedule


def _data_axes(mesh_cfg: MeshConfig | None) -> tuple:
    return mesh_cfg.data_axes if mesh_cfg is not None else ("data",)


def _whole(tree: Dict) -> Dict:
    """A batch or cache dict with each ``ShardedTensor`` gathered whole."""
    return {k: unshard_tensor(v) if isinstance(v, ShardedTensor) else v
            for k, v in tree.items()}


class _Bound(nn.Module):
    """``forward(fn)`` is ``fn(model)``: ``functional_call`` binds the
    model's parameters for the call's duration."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn: Callable):
        return fn(self.model)


def _skeleton(cfg: ModelConfig, mesh) -> Callable[[], nn.Module]:
    """The model's structure on the ``meta`` device.  Over a mesh, where
    the step takes parameters as a dict, it is made with the step (not
    inside it, where a trace of the step on ``meta`` would count its
    parameters as memory the step allocates); else at first use (a
    one-device step given a ``Model`` never uses it)."""
    made = []

    def get() -> nn.Module:
        if not made:
            made.append(_Bound(empty_params(cfg, "meta")))
        return made[0]
    if mesh is not None:
        get()
    return get


def _call(skeleton, params, fn: Callable):
    """``fn(model)``: ``params`` itself when it is a module, else the
    skeleton bound to ``{name: tensor}`` with each ``ShardedTensor``
    gathered whole.  ``fn`` runs entirely inside the binding (a backward
    that re-runs a checkpointed layer must find the same tensors)."""
    if isinstance(params, nn.Module):
        return fn(params)
    whole = {"model." + k: unshard_tensor(v) if isinstance(v, ShardedTensor)
             else v for k, v in params.items()}
    return torch.func.functional_call(skeleton(), whole, (fn,))


def loss_and_grads(cfg: ModelConfig, tc: TrainConfig, params, batch, *,
                   block_skip: bool = False, mesh=None, data_axes=("data",),
                   wrt: Dict | None = None):
    """One batch's training loss under ``tc``'s remat policy, and its
    gradients: (loss, {"lm_loss", "aux_loss"}, {name: gradient}), all
    detached, each gradient in its parameter's dtype (zeros where the
    loss does not reach a parameter).  ``params`` must require
    gradients (``params.requires_grad_()``); ``wrt`` (``{key: tensor}``,
    tensors that require gradients) takes their place as what the
    gradients are of."""
    names, leaves = zip(*(params.named_parameters() if wrt is None
                          else wrt.items()))
    loss, metrics = forward_train_loss(
        cfg, params, batch, remat=tc.remat != "none", block_skip=block_skip,
        remat_policy=tc.remat, mesh=mesh, data_axes=data_axes)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, {
        k: torch.zeros_like(p) if g is None else g
        for k, p, g in zip(names, leaves, grads)}


def make_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None,
                    mesh_cfg: MeshConfig | None = None,
                    block_skip: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the reference's ``make_train_step``; over ``mesh``, see
    ``_sharded_train_step``.

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
    if mesh is not None:
        return _sharded_train_step(cfg, tc, mesh, _data_axes(mesh_cfg),
                                   block_skip)
    gdt = getattr(torch, tc.grad_accum_dtype)

    def train_step(params, opt_state, batch):
        params.requires_grad_()
        M = tc.microbatches
        if M == 1:
            loss, metrics, grads = loss_and_grads(cfg, tc, params, batch,
                                                  block_skip=block_skip)
        else:
            grads = {k: torch.zeros(p.shape, dtype=gdt, device=p.device)
                     for k, p in params.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=next(iter(grads.values())).device)
            for mb in _split_rows(batch, M):
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


def _split_rows(batch: Dict, M: int):
    """The batch's M equal microbatches of rows, in order."""
    rows = next(iter(batch.values())).shape[0]
    if rows % M:
        raise ValueError(f"a batch of {rows} rows does not split into {M} "
                         f"microbatches")
    n = rows // M
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(M)]


def _sharded_train_step(cfg: ModelConfig, tc: TrainConfig, mesh,
                        data_axes: tuple, block_skip: bool):
    """The train step over ``mesh``.  ``params`` is ``{name:
    ShardedTensor}`` and ``opt_state`` ``{"m": {name: ShardedTensor},
    "v": {...}, "step": ShardedTensor or tensor}`` (``shard_tree`` of
    ``adamw_init``'s dict), both updated in place and returned; ``batch``
    holds tensors or ``ShardedTensor``\\ s.  Each microbatch gathers the
    parameters whole, and autograd carries the gradient of each gathered
    tensor back to the one shard of each block that the gather read; the
    microbatches sum as in the one-device step, and AdamW updates those
    shards (a block's other copies, on other devices, then take its
    values)."""
    gdt = getattr(torch, tc.grad_accum_dtype)
    skeleton = _skeleton(cfg, mesh)

    def leaves(tree: Dict) -> Dict:
        """``{(name, block): tensor}``: each block's first shard."""
        return {(k, b): t for k, st in tree.items()
                for b, t in st.blocks().items()}

    def train_step(params, opt_state, batch):
        reps = leaves(params)
        for t in reps.values():
            t.requires_grad_()

        def loss_grads(mb):
            return _call(skeleton, params, lambda model: loss_and_grads(
                cfg, tc, model, mb, block_skip=block_skip, mesh=mesh,
                data_axes=data_axes, wrt=reps))

        M = tc.microbatches
        whole = _whole(batch)
        if M == 1:
            loss, metrics, grads = loss_grads(whole)
        else:
            grads = {k: torch.zeros(t.shape, dtype=gdt, device=t.device)
                     for k, t in reps.items()}
            loss = torch.zeros((), dtype=torch.float32,
                               device=mesh.devices[0])
            for mb in _split_rows(whole, M):
                loss_i, _, g = loss_grads(mb)
                for k, acc in grads.items():
                    acc.add_(g[k].to(gdt))
                loss = loss + loss_i
                del g
            grads = {k: acc / M for k, acc in grads.items()}
            loss = loss / M
            metrics = {"lm_loss": loss, "aux_loss": torch.zeros_like(loss)}
        step = opt_state["step"]
        step_t = (next(iter(step.blocks().values()))
                  if isinstance(step, ShardedTensor) else step)
        lr = lr_schedule(step_t, tc)
        state = {"m": leaves(opt_state["m"]), "v": leaves(opt_state["v"]),
                 "step": step_t}
        _, _, gnorm = adamw_update(grads, state, reps, lr, tc)
        with torch.no_grad():
            for tree in (params, opt_state["m"], opt_state["v"], [step]):
                for st in (tree.values() if isinstance(tree, dict) else tree):
                    if isinstance(st, ShardedTensor):
                        _sync_replicas(st)
        for t in reps.values():
            t.requires_grad_(False)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return params, opt_state, metrics

    return train_step


def _sync_replicas(st: ShardedTensor) -> None:
    """Copy each block's first shard into the block's other tensors (its
    copies on other devices)."""
    firsts = st.blocks()
    for c, t in st.shards.items():
        key = tuple(i for i, _ in st.sharding.block(c, len(st.shape)))
        if t is not firsts[key]:
            t.copy_(firsts[key])


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      mesh_cfg: MeshConfig | None = None,
                      block_skip: bool = False, moe_fsdp: bool = True,
                      quantize_kv_cache: bool = False):
    """``prefill_step(params, batch) -> (logits, cache)``; ``params`` a
    ``Model`` or, over ``mesh``, ``{name: ShardedTensor}`` too."""
    data_axes = _data_axes(mesh_cfg)
    skeleton = _skeleton(cfg, mesh)

    @torch.inference_mode()
    def prefill_step(params, batch):
        return _call(skeleton, params, lambda model: forward_prefill(
            cfg, model, _whole(batch), block_skip=block_skip,
            quantize_kv_cache=quantize_kv_cache, mesh=mesh,
            data_axes=data_axes, moe_fsdp=moe_fsdp))

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


def make_decode_step(cfg: ModelConfig, mesh=None,
                     mesh_cfg: MeshConfig | None = None,
                     moe_fsdp: bool = True, moe_ep_data: bool = False):
    """``decode_step(params, tokens, cache) -> (logits, cache)``; ``params``
    as in ``make_prefill_step``."""
    data_axes = _data_axes(mesh_cfg)
    skeleton = _skeleton(cfg, mesh)

    @torch.inference_mode()
    def decode_step(params, tokens, cache):
        if isinstance(tokens, ShardedTensor):
            tokens = unshard_tensor(tokens)
        return _call(skeleton, params, lambda model: forward_decode(
            cfg, model, tokens, _whole(cache), mesh=mesh,
            data_axes=data_axes, moe_fsdp=moe_fsdp,
            moe_ep_data=moe_ep_data))

    return decode_step
