"""Mixture-of-Experts: top-k routing with capacity-based scatter dispatch,
and expert parallelism over an ``LMMesh``.

Counterpart of the JAX package's ``repro/models/moe.py``.  Dispatch
scatters each kept (token, rank) pair into an (E + 1, C, D) buffer of
expert slots instead of building the (tokens, E, C) one-hot dispatch
tensor; the last row collects the pairs dropped at capacity and is
discarded.  The same code serves train, prefill and decode (S = 1): only
the token count changes.

Over a mesh, the reference's ``shard_map`` bodies run once per mesh
coordinate, on that coordinate's blocks of the tokens and the expert
weights and on its device, through the same ``_moe_local``; where the
reference calls ``all_gather``, ``psum``, ``psum_scatter`` and ``pmean``
the port calls ``distributed.collectives``.  Expert weights are split
over the model axis on the expert dim when ``E % model_size == 0``
(deepseek: 160 / 16, plan "expert"), otherwise on the expert-FFN dim
(grok: 8 experts, plan "ffn"); their FSDP (data/pod) block of d_model is
gathered inside the body.  Capacity is counted per coordinate from its
own tokens, so the tokens dropped differ from ``mesh=None``'s, as in the
reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.distributed.collectives import (all_gather, pmean, psum,
                                                 psum_scatter)
from repro_torch.distributed.sharding import (P, Sharding, ShardedTensor,
                                              shard_tensor, unshard_tensor)
from repro_torch.models.layers import frozen, gelu, normal, param_dtype

# the largest float32 copy of one expert weight stack that _expert_ffn
# makes at a time (its experts are upcast in chunks below this size)
EXPERT_CHUNK_BYTES = 1 << 30


def moe_sharding_plan(cfg: ModelConfig, model_size: int) -> str:
    """'expert': shard the expert dim; 'ffn': shard the expert-FFN dim."""
    return "expert" if cfg.moe.n_experts % model_size == 0 else "ffn"


class MoE(nn.Module):
    """``router`` (d, E); ``w_gate``, ``w_up`` (E, d, f) and ``w_down`` (E,
    f, d); with shared experts ``shared_gate``, ``shared_up`` (d, f·n) and
    ``shared_down`` (f·n, d)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        e = cfg.moe
        d, f, dt = cfg.d_model, e.expert_d_ff, param_dtype(cfg)

        def empty(*shape):
            return frozen(torch.empty(shape, dtype=dt, device=device))

        self.router = empty(d, e.n_experts)
        self.w_gate = empty(e.n_experts, d, f)
        self.w_up = empty(e.n_experts, d, f)
        self.w_down = empty(e.n_experts, f, d)
        if e.n_shared_experts:
            fs = f * e.n_shared_experts
            self.shared_gate = empty(d, fs)
            self.shared_up = empty(d, fs)
            self.shared_down = empty(fs, d)


def init_moe(cfg: ModelConfig, generator: torch.Generator | None,
             device="cuda") -> MoE:
    p = MoE(cfg, device)
    s_out = 0.02 / math.sqrt(2.0 * cfg.n_layers)
    for name, t in p.named_parameters():
        scale = s_out if name in ("w_down", "shared_down") else 0.02
        t.copy_(normal(t.shape, scale, t.dtype, device, generator))
    return p


def _capacity(tokens: int, cfg: ModelConfig, n_local_experts: int) -> int:
    e = cfg.moe
    c = int(tokens * e.top_k / e.n_experts * e.capacity_factor) + 1
    return max(c, e.top_k)


def _expert_ffn(cfg: ModelConfig, xin: torch.Tensor, wg: torch.Tensor,
                wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """xin: (E, C, D); weights (E, D, F) / (E, F, D).  Returns (E, C, D)
    float32.

    The reference multiplies bf16 operands with float32 sums and results
    (``preferred_element_type``).  Here each product upcasts its operands
    to float32, which holds every bf16 value exactly, and multiplies in
    float32 (TF32 off).  The experts go in chunks whose float32 weight
    copy stays under ``EXPERT_CHUNK_BYTES`` (one expert of grok-1 is 805
    MB a matrix).  The activation times the up projection is rounded to
    xin's dtype before the down projection, as in the reference."""
    E, C, D = xin.shape
    f32 = torch.float32
    per = max(1, EXPERT_CHUNK_BYTES // (D * wg.shape[-1] * 4))
    out = torch.empty((E, C, D), dtype=f32, device=xin.device)
    for e0 in range(0, E, per):
        sl = slice(e0, min(E, e0 + per))
        x = xin[sl].to(f32)
        g = torch.bmm(x, wg[sl].to(f32))
        u = torch.bmm(x, wu[sl].to(f32))
        act = gelu(g) if cfg.mlp_variant == "geglu" else F.silu(g)
        h = (act * u).to(xin.dtype)
        out[sl] = torch.bmm(h.to(f32), wd[sl].to(f32))
    return out


def _moe_local(cfg: ModelConfig, x2d: torch.Tensor, router_w, wg, wu, wd,
               expert_offset: int, n_local: int):
    """The MoE body over the experts ``expert_offset`` ..
    ``expert_offset + n_local``.  x2d: (T, D) tokens.  Returns (y (T, D)
    float32, the Switch-style load-balance aux)."""
    e = cfg.moe
    T, D = x2d.shape
    f32 = torch.float32
    logits = torch.matmul(x2d.to(f32), router_w.to(f32))
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    gates, idx = torch.topk(probs, e.top_k, dim=-1)           # (T, k)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # aux load-balance stats (Switch-style) over all E experts
    assign = torch.zeros((T, e.n_experts), dtype=f32, device=x2d.device)
    for r in range(e.top_k):
        assign = assign + F.one_hot(idx[:, r], e.n_experts).to(f32)
    frac_tokens = assign.mean(0) / e.top_k
    frac_probs = probs.mean(0)
    aux = torch.sum(frac_tokens * frac_probs) * e.n_experts

    # local experts; n_local marks a pair this body drops
    local = (idx >= expert_offset) & (idx < expert_offset + n_local)
    lidx = torch.where(local, idx - expert_offset, n_local)
    C = _capacity(T, cfg, n_local)

    # slot of each (t, r) pair: the pairs before it routed to its expert
    flat_e = lidx.reshape(-1)                                 # (T*k,)
    onehot = F.one_hot(flat_e, n_local + 1).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - onehot
    slot = torch.gather(pos, 1, flat_e[:, None])[:, 0]
    keep = (flat_e < n_local) & (slot < C)
    dest_e = torch.where(keep, flat_e, n_local)               # overflow row
    dest_c = torch.where(keep, slot, 0).long()

    # scatter the tokens into (E+1, C, D): each kept slot is written once,
    # the drops all land in the last row, which is discarded
    cdt = x2d.dtype
    tok = torch.repeat_interleave(x2d, e.top_k, dim=0)        # (T*k, D)
    buf = torch.zeros((n_local + 1, C, D), dtype=cdt, device=x2d.device)
    buf.index_put_((dest_e, dest_c), tok, accumulate=True)
    y_exp = _expert_ffn(cfg, buf[:n_local], wg, wu, wd).to(cdt)
    # gather back: pair (t, r) reads y_exp[dest_e, dest_c]
    y_pad = torch.cat([y_exp, torch.zeros((1, C, D), dtype=cdt,
                                          device=x2d.device)], dim=0)
    y_tok = y_pad[dest_e, dest_c].to(f32)                     # (T*k, D)
    g_flat = gates.reshape(-1) * keep.to(f32)
    y = torch.sum((y_tok * g_flat[:, None]).reshape(T, e.top_k, D), dim=1)
    return y, aux


def _blocks(mesh, t: torch.Tensor, *spec) -> dict:
    """``t``'s block at each coordinate under ``spec`` (a body's input)."""
    return shard_tensor(t, Sharding(mesh, P(*spec))).shards


def _whole(mesh, ys: dict, device, *spec) -> torch.Tensor:
    """The body's per-coordinate outputs as the tensor they make up under
    ``spec``, on ``device``."""
    return unshard_tensor(
        ShardedTensor.from_shards(Sharding(mesh, P(*spec)), ys), device)


def _ep_data_forward(cfg: ModelConfig, p: MoE, x: torch.Tensor, mesh,
                     data_axes, model_axis):
    """Serve-EP: experts split over the DATA axes (E % dp == 0), the FFN
    dim over the model axis, so the weights stay resident and no step
    gathers them.  Each coordinate gathers the tokens of every data
    coordinate, runs its local experts over all of them, and the outputs
    reduce-scatter back to the tokens' owners."""
    e = cfg.moe
    D = x.shape[-1]
    dp_size = mesh.size(tuple(data_axes))
    n_local = e.n_experts // dp_size
    xl = _blocks(mesh, x, data_axes, None, None)
    router = _blocks(mesh, p.router)
    wg = _blocks(mesh, p.w_gate, data_axes, None, model_axis)   # (E, D, F)
    wu = _blocks(mesh, p.w_up, data_axes, None, model_axis)
    wd = _blocks(mesh, p.w_down, data_axes, model_axis, None)   # (E, F, D)
    # gather all tokens over the data axes
    xa = xl
    for a in reversed(data_axes):
        xa = all_gather(mesh, xa, a, 0)
    ys, auxs = {}, {}
    for c in mesh.coords():
        off, mult = 0, 1
        for a in reversed(data_axes):
            off += mesh.index(c, a) * mult * n_local
            mult *= mesh.size(a)
        y, auxs[c] = _moe_local(cfg, xa[c].reshape(-1, D), router[c], wg[c],
                                wu[c], wd[c], off, n_local)
        ys[c] = y.to(xl[c].dtype)
    # partial sums over model, then the tokens back to their owners
    ys = psum(mesh, ys, model_axis)
    ys = {c: y.reshape(xa[c].shape) for c, y in ys.items()}
    for a in data_axes:
        ys = psum_scatter(mesh, ys, a, 0)
    auxs = pmean(mesh, auxs, model_axis)
    for a in data_axes:
        auxs = pmean(mesh, auxs, a)
    return (_whole(mesh, ys, x.device, data_axes, None, None),
            auxs[mesh.coords()[0]].to(x.device))


def _sharded_forward(cfg: ModelConfig, p: MoE, x: torch.Tensor, mesh,
                     data_axes, model_axis, fsdp: bool):
    """The "expert" or "ffn" plan (``moe_sharding_plan``)."""
    e = cfg.moe
    D = x.shape[-1]
    msize = mesh.size(model_axis)
    plan = moe_sharding_plan(cfg, msize)
    wdp = data_axes if fsdp else None
    if plan == "expert":
        n_local = e.n_experts // msize
        specs = ((model_axis, wdp, None), (model_axis, wdp, None),
                 (model_axis, None, wdp))
    else:
        n_local = e.n_experts
        specs = ((None, wdp, model_axis), (None, wdp, model_axis),
                 (None, model_axis, wdp))
    xl = _blocks(mesh, x, data_axes, None, None)
    router = _blocks(mesh, p.router)
    wg, wu, wd = (_blocks(mesh, w, *sp) for w, sp in
                  zip((p.w_gate, p.w_up, p.w_down), specs))
    if fsdp:
        # gather the FSDP (data) block of the expert weights
        for a in reversed(data_axes):
            wg = all_gather(mesh, wg, a, 1)
            wu = all_gather(mesh, wu, a, 1)
            wd = all_gather(mesh, wd, a, 2)
    ys, auxs = {}, {}
    for c in mesh.coords():
        off = mesh.index(c, model_axis) * n_local if plan == "expert" else 0
        y, auxs[c] = _moe_local(cfg, xl[c].reshape(-1, D), router[c], wg[c],
                                wu[c], wd[c], off, n_local)
        # bf16 on the wire, as in the reference
        ys[c] = y.to(xl[c].dtype)
    ys = psum(mesh, ys, model_axis)
    auxs = pmean(mesh, auxs, model_axis)
    for a in data_axes:
        auxs = pmean(mesh, auxs, a)
    ys = {c: y.reshape(xl[c].shape) for c, y in ys.items()}
    return (_whole(mesh, ys, x.device, data_axes, None, None),
            auxs[mesh.coords()[0]].to(x.device))


def moe_forward(cfg: ModelConfig, p: MoE, x: torch.Tensor, *, mesh=None,
                data_axes=("data",), model_axis: str = "model",
                fsdp: bool = True, ep_data: bool = False):
    """x: (B, S, D) -> (out (B, S, D), aux_loss scalar).

    With ``mesh`` (an ``LMMesh``), the routed experts run per coordinate
    under the sharding plan, or under serve-EP with ``ep_data``; the
    tokens split over ``data_axes``, which must divide B."""
    e = cfg.moe
    D = x.shape[-1]
    if mesh is None:
        y, aux = _moe_local(cfg, x.reshape(-1, D), p.router, p.w_gate,
                            p.w_up, p.w_down, 0, e.n_experts)
        out = y.reshape(x.shape).to(x.dtype)
    elif ep_data:
        out, aux = _ep_data_forward(cfg, p, x, mesh, tuple(data_axes),
                                    model_axis)
    else:
        out, aux = _sharded_forward(cfg, p, x, mesh, tuple(data_axes),
                                    model_axis, fsdp)
    if e.n_shared_experts:
        g = torch.matmul(x, p.shared_gate)
        u = torch.matmul(x, p.shared_up)
        out = out + torch.matmul(F.silu(g) * u, p.shared_down)
    return out, aux * e.aux_loss_weight
