"""Attention: GQA with blockwise (flash-style) softmax, sliding windows,
single-token decode against a KV cache (bfloat16 or int8), and
DeepSeek-V2 MLA (multi-head latent attention) with matrix absorption for
decode.

Counterpart of the JAX package's ``repro/models/attention.py``.  Attention is
plain PyTorch on both devices, as the reference's is plain jnp: scores,
softmax statistics and the weighted sums in float32 from the inputs, the
reference's own formulation.  Two schedules exist:

* rectangular (default): every (q-chunk, kv-chunk) block is computed and
  masked;
* triangular (``block_skip=True``): only the blocks on or below the
  diagonal.

The blocks run kv-chunk by kv-chunk over all q rows at once (the
reference maps over q chunks and scans the kv chunks of each).  Rows are
independent, so each row sees the same updates in the same order as in
the reference; the triangular schedule starts kv chunk j at q row
``j * q_chunk``.

Over an ``LMMesh`` whose model axis the heads do not divide (whisper 12,
qwen 40, hymba 25 heads), causal ``gqa_forward`` splits the sequence
instead (``_seq_sharded_attention``): each model coordinate attends with
its query rows to the K/V gathered over the model axis.

Decode writes the new token's K/V into the cache tensors it is given, in
place, and returns them; ``transformer.forward_decode`` hands it copies.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.distributed.collectives import all_gather
from repro_torch.distributed.sharding import (P, Sharding, ShardedTensor,
                                              shard_tensor, unshard_tensor)
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.layers import apply_rope, frozen, normal, param_dtype

_NEG_INF = -1e30


# ---------------------------------------------------------------------------
# int8 KV-cache quantization (serving): per-token scales
# ---------------------------------------------------------------------------

def quantize_kv(x: torch.Tensor, head_dims: int = 2):
    """x: (..., KVH, dh) -> (int8 values, float32 per-token scales).

    Scales are shared across the trailing ``head_dims`` axes (heads and
    head_dim), as in the reference."""
    ax = tuple(range(x.dim() - head_dims, x.dim()))
    xf = x.float()
    s = torch.amax(torch.abs(xf), dim=ax) / 127.0
    s = torch.clamp_min(s, 1e-8)
    sb = s.reshape(s.shape + (1,) * head_dims)
    q = torch.clamp(torch.round(xf / sb), -127, 127).to(torch.int8)
    return q, s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    head_dims = q.dim() - s.dim()
    return q.float() * s.reshape(s.shape + (1,) * head_dims)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """GQA: ``wq`` (d, H, dh), ``wk``/``wv`` (d, KVH, dh), ``wo`` (H, dh,
    d), and ``bq``/``bk``/``bv`` with ``qkv_bias``.  MLA: ``wq_a`` (d, q
    rank) and ``q_norm`` when the query is compressed, ``wq_b``, ``wkv_a``,
    ``wkv_b_nope``, ``wkv_b_v``, ``wo`` and ``kv_norm``."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        dt = param_dtype(cfg)
        d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head

        def empty(*shape):
            return frozen(torch.empty(shape, dtype=dt, device=device))

        if cfg.mla.enabled:
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            if m.q_lora_rank:
                self.wq_a = empty(d, m.q_lora_rank)
            self.wq_b = empty(m.q_lora_rank or d, h, qk)
            self.wkv_a = empty(d, m.kv_lora_rank + m.qk_rope_head_dim)
            self.wkv_b_nope = empty(m.kv_lora_rank, h, m.qk_nope_head_dim)
            self.wkv_b_v = empty(m.kv_lora_rank, h, m.v_head_dim)
            self.wo = empty(h, m.v_head_dim, d)
            if m.q_lora_rank:
                self.q_norm = empty(m.q_lora_rank)
            self.kv_norm = empty(m.kv_lora_rank)
            return
        self.wq = empty(d, h, dh)
        self.wk = empty(d, kvh, dh)
        self.wv = empty(d, kvh, dh)
        self.wo = empty(h, dh, d)
        if cfg.qkv_bias:
            self.bq = empty(h, dh)
            self.bk = empty(kvh, dh)
            self.bv = empty(kvh, dh)


def init_attention(cfg: ModelConfig, generator: torch.Generator | None,
                   device="cuda") -> Attention:
    """Projections ``normal * 0.02`` (``wo`` scaled by 1/sqrt(2L)), biases
    zero, norm scales one."""
    p = Attention(cfg, device)
    s_out = 0.02 / math.sqrt(2.0 * cfg.n_layers)
    for name, t in p.named_parameters():
        if name in ("q_norm", "kv_norm"):
            t.fill_(1.0)
        elif name in ("bq", "bk", "bv"):
            t.zero_()
        else:
            t.copy_(normal(t.shape, s_out if name == "wo" else 0.02,
                           t.dtype, device, generator))
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk")."""
    return torch.matmul(x, w.reshape(w.shape[0], -1)).reshape(
        x.shape[:-1] + w.shape[1:])


def _out(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    return torch.matmul(o.reshape(o.shape[:-2] + (-1,)),
                        wo.reshape(-1, wo.shape[-1]))


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention
# ---------------------------------------------------------------------------

def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, q_offset: int = 0,
                        window: int = 0, q_chunk: int = 512,
                        kv_chunk: int = 512,
                        block_skip: bool = False) -> torch.Tensor:
    """q: (B, Sq, H, dh); k, v: (B, Sk, KVH, dh) -> (B, Sq, H, dh).

    Online softmax over kv chunks, in float32; GQA by grouping the H query
    heads G = H // KVH to a kv head.  K and V are zero-padded to a
    multiple of the kv chunk, and the padding masked, as in the
    reference.  The triangular schedule runs where the reference's does
    (``block_skip``, causal, no window, equal chunks, no q offset)."""
    B, Sq, H, dh = q.shape
    _, Sk, KVH, _ = k.shape
    G = H // KVH
    scale = 1.0 / math.sqrt(dh)
    dev = q.device

    qc = min(q_chunk, Sq)
    kc = min(kv_chunk, Sk)
    nq = -(-Sq // qc)
    nk = -(-Sk // kc)
    k_pad = nk * kc - Sk
    triangular = (block_skip and causal and window == 0 and qc == kc
                  and q_offset == 0)

    # (B, KVH, rows, dh) layouts, float32, made once
    qf = q.reshape(B, Sq, KVH, G, dh).permute(0, 2, 1, 3, 4).to(
        torch.float32, memory_format=torch.contiguous_format)
    kf, vf = (t.transpose(1, 2).to(torch.float32,
                                   memory_format=torch.contiguous_format)
              for t in (k, v))
    if k_pad:
        kf = torch.nn.functional.pad(kf, (0, 0, 0, k_pad))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, k_pad))

    # the running statistics of the rows the current kv chunk reaches;
    # rebuilt each chunk, never written in place, so autograd can
    # differentiate through them
    m = torch.full((B, KVH, Sq, G), _NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, KVH, Sq, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KVH, Sq, G, dh), dtype=torch.float32, device=dev)
    done_l, done_acc = [], []   # triangular: rows no later chunk reaches
    qpos = q_offset + torch.arange(Sq, device=dev)
    for j in range(min(nk, nq) if triangular else nk):
        r0 = j * qc if triangular else 0
        if r0:
            done_l.append(l[:, :, :qc])
            done_acc.append(acc[:, :, :qc])
            m, l, acc = m[:, :, qc:], l[:, :, qc:], acc[:, :, qc:]
        R = Sq - r0
        kj, vj = kf[:, :, j * kc:(j + 1) * kc], vf[:, :, j * kc:(j + 1) * kc]
        s = torch.matmul(qf[:, :, r0:].reshape(B, KVH, R * G, dh),
                         kj.transpose(-1, -2)).reshape(B, KVH, R, G, kc)
        s = s * scale
        kpos = j * kc + torch.arange(kc, device=dev)
        diff = qpos[r0:, None] - kpos[None, :]
        mask = (kpos < Sk)[None, :].expand(R, kc)
        if causal:
            mask = mask & (diff >= 0)
        if window > 0:
            mask = mask & (diff < window)
        s = torch.where(mask[None, None, :, None, :], s, _NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.matmul(p.reshape(B, KVH, R * G, kc), vj)
        acc = acc * corr[..., None] + pv.reshape(B, KVH, R, G, dh)
        m = m_new
    if done_l:
        l = torch.cat(done_l + [l], dim=2)
        acc = torch.cat(done_acc + [acc], dim=2)
    o = acc / torch.clamp_min(l, 1e-20)[..., None]
    return o.permute(0, 2, 1, 3, 4).reshape(B, Sq, H, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA forward (prefill) and decode
# ---------------------------------------------------------------------------

def _project_qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                 positions: torch.Tensor | None):
    q, k, v = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if positions is not None:
        q = apply_rope(q.transpose(1, 2), positions,
                       cfg.rope_theta).transpose(1, 2)
        k = apply_rope(k.transpose(1, 2), positions,
                       cfg.rope_theta).transpose(1, 2)
    return q, k, v


def _seq_sharded_attention(q, k, v, *, mesh, data_axes, causal: bool,
                           window: int, model_axis: str = "model"):
    """Sequence-parallel attention: q, k and v (B, S, ·, dh) split over
    ``data_axes`` on the batch and over the model axis on the sequence;
    each coordinate gathers K/V over the model axis and attends with its
    query rows, the causal mask and the window at its sequence offset.
    Returns the whole (B, S, H, dh) output."""
    sharding = Sharding(mesh, P(tuple(data_axes), model_axis, None, None))
    ql, kl, vl = (shard_tensor(t, sharding).shards for t in (q, k, v))
    kf = all_gather(mesh, kl, model_axis, 1)
    vf = all_gather(mesh, vl, model_axis, 1)
    out = {}
    for c in mesh.coords():
        off = mesh.index(c, model_axis) * ql[c].shape[1]
        out[c] = blockwise_attention(ql[c], kf[c], vf[c], causal=causal,
                                     q_offset=off, window=window)
    return unshard_tensor(ShardedTensor.from_shards(sharding, out), q.device)


def gqa_forward(cfg: ModelConfig, p: Attention, x: torch.Tensor, *,
                positions: torch.Tensor | None, causal: bool = True,
                block_skip: bool = False,
                kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
                mesh=None, data_axes=("data",)):
    """Full-sequence attention.  Returns (out, (k, v)) for the cache.

    ``kv_override`` supplies external K/V (cross-attention); the query is
    then projected without RoPE.  With ``mesh``, causal attention whose
    heads do not divide the model axis, and whose sequence does, runs
    sequence-sharded (the reference's rule)."""
    if kv_override is not None:
        k, v = kv_override
        q = _proj(x, p.wq)
        if cfg.qkv_bias:
            q = q + p.bq
    else:
        q, k, v = _project_qkv(cfg, p, x, positions)
    use_seq_shard = False
    if mesh is not None and "model" in mesh.axis_names:
        tp = mesh.size("model")
        seq_ok = (q.shape[1] % tp == 0 and k.shape[1] % tp == 0
                  and q.shape[1] == k.shape[1])
        use_seq_shard = (cfg.n_heads % tp != 0) and seq_ok and causal
    if use_seq_shard:
        o = _seq_sharded_attention(q, k, v, mesh=mesh, data_axes=data_axes,
                                   causal=causal, window=cfg.sliding_window)
    else:
        o = blockwise_attention(q, k, v, causal=causal,
                                window=cfg.sliding_window,
                                block_skip=block_skip)
    return _out(o, p.wo), (k, v)


def cross_kv(cfg: ModelConfig, p: Attention, enc: torch.Tensor):
    """Cross-attention K/V from encoder states."""
    k, v = _proj(enc, p.wk), _proj(enc, p.wv)
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    return k, v


def _heads_f32(c: torch.Tensor) -> torch.Tensor:
    """A (B, S, KVH, dh) cache as (B, KVH, S, dh) float32, one copy."""
    return c.transpose(1, 2).to(torch.float32,
                                memory_format=torch.contiguous_format)


def _write_slot(cache: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """``cache[:, slot] = new[:, 0]`` with the slot on the device, clamped
    into the cache as ``lax.dynamic_update_slice`` clamps it."""
    slot = torch.clamp(slot, 0, cache.shape[1] - 1).reshape(1).long()
    cache.index_copy_(1, slot, new.to(cache.dtype))


def gqa_decode(cfg: ModelConfig, p: Attention, x: torch.Tensor,
               cache_k: torch.Tensor, cache_v: torch.Tensor,
               position: torch.Tensor, *, update_cache: bool = True,
               k_scale: torch.Tensor | None = None,
               v_scale: torch.Tensor | None = None):
    """Single-token decode.  x: (B, 1, d); cache: (B, S, KVH, dh); position:
    an int32 scalar tensor.

    With a sliding window the cache is a ring buffer of size ``window``.
    int8 caches carry per-token ``k_scale``/``v_scale`` (B, S), folded into
    the scores and the softmax weights.  With ``update_cache`` the new
    token's K/V (and scales) are written into the tensors passed in.

    Returns (out, cache_k, cache_v[, k_scale, v_scale])."""
    B = x.shape[0]
    S = cache_k.shape[1]
    H, KVH, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // KVH
    scale = 1.0 / math.sqrt(dh)
    quantized = k_scale is not None
    position = torch.as_tensor(position, device=x.device)

    pos_vec = position.reshape(1)
    q, k_new, v_new = _proj(x, p.wq), _proj(x, p.wk), _proj(x, p.wv)
    if cfg.qkv_bias:
        q, k_new, v_new = q + p.bq, k_new + p.bk, v_new + p.bv
    q = apply_rope(q.transpose(1, 2), pos_vec, cfg.rope_theta).transpose(1, 2)
    k_new = apply_rope(k_new.transpose(1, 2), pos_vec,
                       cfg.rope_theta).transpose(1, 2)

    if update_cache:
        slot = position % S if cfg.sliding_window > 0 else position
        if quantized:
            kq, ks = quantize_kv(k_new)        # ks: (B, 1)
            vq, vs = quantize_kv(v_new)
            _write_slot(cache_k, slot, kq)
            _write_slot(cache_v, slot, vq)
            _write_slot(k_scale, slot, ks)
            _write_slot(v_scale, slot, vs)
        else:
            _write_slot(cache_k, slot, k_new)
            _write_slot(cache_v, slot, v_new)

    kpos = torch.arange(S, device=x.device)
    if cfg.sliding_window > 0:
        # ring buffer: slot i holds the latest position p with p % S == i
        latest = position - ((position - kpos) % S)
        valid = (latest >= 0) & (latest >= position - cfg.sliding_window + 1)
        valid = valid | (kpos == (position % S))
    else:
        valid = kpos <= position

    qg = q.reshape(B, KVH, G, dh).float()
    s_ = torch.matmul(qg, _heads_f32(cache_k).transpose(-1, -2))  # (B,K,G,S)
    if quantized:
        # dequantize on the fly: scores = (q . k_q) * s_k
        s_ = s_ * k_scale[:, None, None, :] * scale
    else:
        s_ = s_ * scale
    s_ = torch.where(valid[None, None, None, :], s_, _NEG_INF)
    w = torch.softmax(s_, dim=-1)
    if quantized:
        w = w * v_scale[:, None, None, :]
    o = torch.matmul(w, _heads_f32(cache_v))                     # (B,K,G,dh)
    o = o.reshape(B, 1, H, dh).to(x.dtype)
    out = _out(o, p.wo)
    if quantized:
        return out, cache_k, cache_v, k_scale, v_scale
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------

def _rms(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm, eps 1e-6: the reference's ``_rms`` is ``apply_norm``'s
    arithmetic, so it runs the RMSNorm kernel on a card."""
    return rmsnorm(x, scale, eps=1e-6)


def _mla_q(cfg: ModelConfig, p: Attention, x, positions):
    m = cfg.mla
    ql = _rms(torch.matmul(x, p.wq_a), p.q_norm) if m.q_lora_rank else x
    q = _proj(ql, p.wq_b)
    q_nope = q[..., :m.qk_nope_head_dim]
    q_rope = apply_rope(q[..., m.qk_nope_head_dim:].transpose(1, 2),
                        positions, cfg.rope_theta).transpose(1, 2)
    return q_nope, q_rope


def _mla_latent(cfg: ModelConfig, p: Attention, x, positions):
    m = cfg.mla
    kv = torch.matmul(x, p.wkv_a)
    ckv = _rms(kv[..., :m.kv_lora_rank], p.kv_norm)
    k_rope = apply_rope(kv[..., m.kv_lora_rank:][:, None], positions,
                        cfg.rope_theta)[:, 0]                # (B, S, rope)
    return ckv, k_rope


def mla_forward(cfg: ModelConfig, p: Attention, x: torch.Tensor, *,
                positions: torch.Tensor, block_skip: bool = False):
    """Full-sequence MLA.  Returns (out, (ckv, k_rope)), the latent
    cache."""
    m = cfg.mla
    q_nope, q_rope = _mla_q(cfg, p, x, positions)
    ckv, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope = _proj(ckv, p.wkv_b_nope)
    v = _proj(ckv, p.wkv_b_v)
    H = cfg.n_heads
    k_rope_b = k_rope[:, :, None, :].expand(k_rope.shape[:2]
                                            + (H, m.qk_rope_head_dim))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope_b], dim=-1)
    # pad v's head dim up to the qk dim so the blockwise helper is reused
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    v_pad = torch.nn.functional.pad(v, (0, qk_dim - m.v_head_dim))
    o = blockwise_attention(q, k, v_pad, causal=True, block_skip=block_skip)
    out = _out(o[..., :m.v_head_dim], p.wo)
    return out, (ckv, k_rope)


def mla_decode(cfg: ModelConfig, p: Attention, x: torch.Tensor,
               cache_ckv: torch.Tensor, cache_krope: torch.Tensor,
               position: torch.Tensor):
    """Matrix-absorbed MLA decode (DeepSeek-V2 inference optimization).

    Scores are computed in the latent space: the per-head nope projection
    is absorbed into the query, so the cache stays (B, S, r).  The new
    token's latents are written into the caches passed in.  Returns (out,
    cache_ckv, cache_krope)."""
    m = cfg.mla
    S = cache_ckv.shape[1]
    position = torch.as_tensor(position, device=x.device)
    pos_vec = position.reshape(1)

    q_nope, q_rope = _mla_q(cfg, p, x, pos_vec)             # (B,1,H,*)
    ckv_new, krope_new = _mla_latent(cfg, p, x, pos_vec)
    _write_slot(cache_ckv, position, ckv_new)
    _write_slot(cache_krope, position, krope_new)

    f32 = torch.float32
    # absorb W_k_nope into q: (B,1,H,nope) x (r,H,nope) -> (B,H,r)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0].to(f32),
                         p.wkv_b_nope.to(f32))
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    ckv = cache_ckv.to(f32)
    s = (torch.matmul(q_lat, ckv.transpose(1, 2))
         + torch.matmul(q_rope[:, 0].to(f32),
                        cache_krope.to(f32).transpose(1, 2))) * scale
    valid = torch.arange(S, device=x.device) <= position
    s = torch.where(valid[None, None, :], s, _NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.matmul(w, ckv)                              # (B,H,r)
    o = torch.einsum("bhr,rhk->bhk", o_lat, p.wkv_b_v.to(f32))  # (B,H,v)
    out = _out(o.to(x.dtype)[:, None], p.wo)                 # (B,1,d)
    return out, cache_ckv, cache_krope
