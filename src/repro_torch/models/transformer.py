"""The decoder stack for every model family: dense GQA decoders (llama3,
qwen, minitron, olmo), MoE decoders (grok, deepseek with MLA), pure SSM
(mamba2), hybrid attention ∥ SSM (hymba), encoder-decoder (whisper) and
VLM prefix models (llava).

Counterpart of the JAX package's ``repro/models/transformer.py``.  Layers
run in a Python loop where the JAX package scans over stacked layer
parameters, and remat is
``torch.utils.checkpoint`` where the JAX package has ``jax.checkpoint``
(``_remat``); the decode cache keeps the JAX package's
stacked keys and layouts, so the two packages' caches compare directly:

  k, v:     (L, B, S, KVH, dh) in the model's dtype, or int8 with
  k_s, v_s: (L, B, S) float32 scales (``quantize_kv_cache``)
  ckv:      (L, B, S, kv_lora_rank), krope: (L, B, S, rope dim)   (MLA)
  xk, xv:   (L, B, enc_len, KVH, dh)                             (encdec)
  ssm:      (L, B, H, P, N) float32
  conv:     (L, B, K-1, conv_ch) in the model's dtype
  pos:      int32 scalar

With a sliding window, k and v hold a ring buffer of ``window`` slots.

``mesh=`` (an ``LMMesh``) runs the reference's explicit per-shard code:
sequence-sharded attention (``attention._seq_sharded_attention``) and the
MoE plans (``moe.moe_forward``).  Everything between those bodies is
placed by GSPMD in the reference and computes the numbers of one device;
the port computes it on whole tensors on the controller's device, and
``_constrain`` only checks its spec against the mesh.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import P, Sharding
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.frontend import (Frontend, apply_frontend,
                                         enc_len_for, init_frontend,
                                         sinusoidal_positions)
from repro_torch.models.layers import (MLP, Embedding, LMHead, Norm,
                                       apply_mlp, apply_norm, embed_tokens,
                                       init_embedding, init_lm_head, init_mlp,
                                       init_norm, lm_head_logits, param_dtype)
from repro_torch.models.moe import MoE, init_moe, moe_forward


def _constrain(x: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """Anchor an activation's sharding (a no-op outside a mesh).  The
    port computes activations whole, so this checks that ``spec`` names
    axes of ``mesh`` and fits ``x``'s rank, places nothing, and returns
    ``x``; as under GSPMD, a dim need not divide its axes."""
    if mesh is not None:
        Sharding(mesh, spec).block(mesh.coords()[0], x.dim())
    return x


class DecoderLayer(nn.Module):
    """One decoder layer: ``norm1``, then as the family has them ``attn``,
    ``ssm``, ``norm_x`` and ``xattn`` (encdec), and ``norm2`` with ``moe``
    or ``mlp``."""

    def __init__(self, **parts: nn.Module):
        super().__init__()
        for name, module in parts.items():
            setattr(self, name, module)


class EncoderLayer(DecoderLayer):
    """One encoder layer: ``norm1``, ``attn``, ``norm2``, ``mlp``."""


class Model(nn.Module):
    """``embed``, ``layers`` (one ``DecoderLayer`` each), ``final_norm``,
    ``lm_head``, and for encdec ``enc_layers`` and ``enc_final_norm``, and
    with a frontend ``frontend``: the JAX package's parameter tree, its
    layer axis unstacked."""

    def __init__(self, embed: Embedding, layers, final_norm: Norm,
                 lm_head: LMHead, *, enc_layers=None,
                 enc_final_norm: Norm | None = None,
                 frontend: Frontend | None = None):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.lm_head = lm_head
        if enc_layers is not None:
            self.enc_layers = nn.ModuleList(enc_layers)
            self.enc_final_norm = enc_final_norm
        if frontend is not None:
            self.frontend = frontend


def _build(cfg: ModelConfig, make: dict) -> Model:
    """The model's structure, each part made by ``make[kind]()``, in the
    JAX package's key order."""
    def decoder_layer() -> DecoderLayer:
        parts = {"norm1": make["norm"]()}
        if cfg.family != "ssm":
            parts["attn"] = make["attn"]()
        if cfg.family in ("ssm", "hybrid"):
            parts["ssm"] = make["ssm"]()
        if cfg.family == "encdec":
            parts["norm_x"] = make["norm"]()
            parts["xattn"] = make["attn"]()
        if cfg.family == "moe":
            parts["norm2"] = make["norm"]()
            parts["moe"] = make["moe"]()
        elif cfg.d_ff > 0:
            parts["norm2"] = make["norm"]()
            parts["mlp"] = make["mlp"]()
        return DecoderLayer(**parts)

    layers = [decoder_layer() for _ in range(cfg.n_layers)]
    embed, final_norm, lm_head = make["embed"](), make["norm"](), \
        make["lm_head"]()
    extra = {}
    if cfg.family == "encdec":
        extra["enc_layers"] = [
            EncoderLayer(norm1=make["norm"](), attn=make["attn"](),
                         norm2=make["norm"](), mlp=make["mlp"]())
            for _ in range(cfg.n_encoder_layers)]
        extra["enc_final_norm"] = make["norm"]()
    if cfg.frontend != "none":
        extra["frontend"] = make["frontend"]()
    return Model(embed, layers, final_norm, lm_head, **extra)


def empty_params(cfg: ModelConfig, device="cuda") -> Model:
    """The model with its parameters allocated, not initialised."""
    dev = resolve_device(device)
    return _build(cfg, {
        "norm": lambda: Norm(cfg, dev),
        "attn": lambda: attn.Attention(cfg, dev),
        "ssm": lambda: ssm_mod.SSM(cfg, dev),
        "moe": lambda: MoE(cfg, dev),
        "mlp": lambda: MLP(cfg, dev),
        "embed": lambda: Embedding(cfg, dev),
        "lm_head": lambda: LMHead(cfg, dev),
        "frontend": lambda: Frontend(cfg, dev)})


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> Model:
    """Random weights, drawn as the JAX package draws them (normals scaled
    and cast to the model's dtype) but from ``generator``, a
    ``torch.Generator`` on ``device``: the numbers differ from the JAX
    package's.  Tests carry JAX weights over with
    ``convert.params_from_numpy`` instead."""
    dev = resolve_device(device)
    g = generator
    return _build(cfg, {
        "norm": lambda: init_norm(cfg, dev),
        "attn": lambda: attn.init_attention(cfg, g, dev),
        "ssm": lambda: ssm_mod.init_ssm(cfg, g, dev),
        "moe": lambda: init_moe(cfg, g, dev),
        "mlp": lambda: init_mlp(cfg, g, dev),
        "embed": lambda: init_embedding(cfg, g, dev),
        "lm_head": lambda: init_lm_head(cfg, g, dev),
        "frontend": lambda: init_frontend(cfg, g, dev)})


# ---------------------------------------------------------------------------
# Layer bodies (full-sequence)
# ---------------------------------------------------------------------------

def _decoder_layer_fwd(cfg: ModelConfig, p: DecoderLayer, x, positions, *,
                       block_skip: bool, enc_states=None,
                       want_cache: bool, mesh=None, data_axes=("data",),
                       moe_fsdp: bool = True):
    """Returns (x, cache dict or None, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = {}
    h = apply_norm(cfg, p.norm1, x)

    if cfg.family == "ssm":
        out, (hT, conv) = ssm_mod.ssm_forward(cfg, p.ssm, h)
        cache["ssm"], cache["conv"] = hT, conv
    elif cfg.family == "hybrid":
        a_out, (k, v) = attn.gqa_forward(cfg, p.attn, h, positions=positions,
                                         block_skip=block_skip, mesh=mesh,
                                         data_axes=data_axes)
        s_out, (hT, conv) = ssm_mod.ssm_forward(cfg, p.ssm, h)
        out = (a_out + s_out) * 0.5
        cache.update(k=k, v=v, ssm=hT, conv=conv)
    elif cfg.mla.enabled:
        out, (ckv, krope) = attn.mla_forward(cfg, p.attn, h,
                                             positions=positions,
                                             block_skip=block_skip)
        cache["ckv"], cache["krope"] = ckv, krope
    else:
        out, (k, v) = attn.gqa_forward(cfg, p.attn, h, positions=positions,
                                       block_skip=block_skip, mesh=mesh,
                                       data_axes=data_axes)
        cache["k"], cache["v"] = k, v
    x = x + out

    if cfg.family == "encdec":
        hx = apply_norm(cfg, p.norm_x, x)
        xk, xv = attn.cross_kv(cfg, p.xattn, enc_states)
        xo, _ = attn.gqa_forward(cfg, p.xattn, hx, positions=positions,
                                 causal=False, kv_override=(xk, xv))
        x = x + xo
        cache["xk"], cache["xv"] = xk, xv

    if cfg.family == "moe":
        h2 = apply_norm(cfg, p.norm2, x)
        out2, aux = moe_forward(cfg, p.moe, h2, mesh=mesh,
                                data_axes=data_axes, fsdp=moe_fsdp)
        x = x + out2
    elif cfg.d_ff > 0:
        h2 = apply_norm(cfg, p.norm2, x)
        x = x + apply_mlp(cfg, p.mlp, h2)
    return x, (cache if want_cache else None), aux


def _encoder_layer_fwd(cfg: ModelConfig, p: EncoderLayer, x):
    h = apply_norm(cfg, p.norm1, x)
    out, _ = attn.gqa_forward(cfg, p.attn, h, positions=None, causal=False)
    x = x + out
    h2 = apply_norm(cfg, p.norm2, x)
    return x + apply_mlp(cfg, p.mlp, h2)


# ---------------------------------------------------------------------------
# Full-model forward (train / prefill)
# ---------------------------------------------------------------------------

def _remat(fn, *args):
    """``fn(*args)`` under an activation checkpoint: what it saves for
    backward is dropped after the forward and made again by re-running
    ``fn`` when backward needs it (``jax.checkpoint``'s counterpart).  The
    model draws no random numbers, so no RNG state is kept."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _run_encoder(cfg: ModelConfig, params: Model, frame_embeds, *,
                 remat: bool = False, mesh=None, data_axes=("data",)):
    x = apply_frontend(cfg, params.frontend, frame_embeds)
    pe = sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    x = x + pe[None]
    act_spec = P(tuple(data_axes), None, None)
    x = _constrain(x, mesh, act_spec)
    for layer in params.enc_layers:
        x = (_remat(_encoder_layer_fwd, cfg, layer, x) if remat
             else _encoder_layer_fwd(cfg, layer, x))
        x = _constrain(x, mesh, act_spec)
    return apply_norm(cfg, params.enc_final_norm, x)


def _embed_inputs(cfg: ModelConfig, params: Model, batch):
    """Returns (x (B, S, D), positions (S,)); vlm puts the patches
    first."""
    tok_emb = embed_tokens(params.embed, batch["tokens"])
    if cfg.family == "vlm":
        patches = apply_frontend(cfg, params.frontend,
                                 batch["patch_embeds"]).to(tok_emb.dtype)
        x = torch.cat([patches, tok_emb], dim=1)
    else:
        x = tok_emb
    return x, torch.arange(x.shape[1], device=x.device)


def block_size(n_layers: int) -> int:
    """Largest divisor of n_layers <= sqrt(n_layers) (sqrt-remat
    blocks)."""
    return max(b for b in range(1, math.isqrt(n_layers) + 1)
               if n_layers % b == 0)


def forward_hidden(cfg: ModelConfig, params: Model, batch, *,
                   block_skip: bool = False, want_cache: bool = False,
                   remat: bool = False, remat_policy: str = "layer",
                   mesh=None, data_axes=("data",), moe_fsdp: bool = True):
    """Embed + all decoder layers + the final norm.  Returns (hidden (B,
    S, D), the cache dict of layer-stacked entries or None, the summed MoE
    aux loss, the encoder states or None).

    ``remat`` checkpoints each layer (and each encoder layer).
    ``remat_policy='block'`` (without ``want_cache``) is sqrt-remat, as
    in the reference: blocks of ``block_size(L)`` layers, each block
    checkpointed whole with a checkpoint around each of its layers
    inside, so backward keeps only the blocks' boundary residuals and
    runs a block's layers again twice (the block, then each layer),
    but for its last, before which the block's recompute stops."""
    enc_states = None
    if cfg.family == "encdec":
        enc_states = _run_encoder(cfg, params, batch["frame_embeds"],
                                  remat=remat, mesh=mesh,
                                  data_axes=data_axes)
    x, positions = _embed_inputs(cfg, params, batch)
    act_spec = P(tuple(data_axes), None, None)
    x = _constrain(x, mesh, act_spec)

    def layer_fwd(layer, x, aux):
        x, cache, aux_l = _decoder_layer_fwd(
            cfg, layer, x, positions, block_skip=block_skip,
            enc_states=enc_states, want_cache=want_cache, mesh=mesh,
            data_axes=data_axes, moe_fsdp=moe_fsdp)
        return _constrain(x, mesh, act_spec), aux + aux_l, cache

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = list(params.layers)
    per_layer: dict[str, list] = {}
    if remat and remat_policy == "block" and not want_cache:
        bs = block_size(cfg.n_layers)

        def block_fwd(i0, x, aux):
            for layer in layers[i0:i0 + bs]:
                x, aux, _ = _remat(layer_fwd, layer, x, aux)
            return x, aux

        for i0 in range(0, len(layers), bs):
            x, aux = _remat(block_fwd, i0, x, aux)
    else:
        for layer in layers:
            x, aux, cache = (_remat(layer_fwd, layer, x, aux) if remat
                             else layer_fwd(layer, x, aux))
            for k, t in (cache or {}).items():
                per_layer.setdefault(k, []).append(t)
    x = apply_norm(cfg, params.final_norm, x)
    caches = ({k: torch.stack(ts) for k, ts in per_layer.items()}
              if want_cache else None)
    return x, caches, aux, enc_states


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------

def _chunk_nll(cfg: ModelConfig, params: Model, h: torch.Tensor,
               labels: torch.Tensor, mesh=None, data_axes=("data",)):
    """(sum of the valid labels' negative log-likelihoods, their count)
    over one chunk, from float32 logits."""
    logits = lm_head_logits(cfg, params.embed, params.lm_head, h).float()
    logits = _constrain(logits, mesh, P(tuple(data_axes), None, "model"))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp_min(labels, 0).long()[..., None])[..., 0]
    valid = (labels >= 0).float()
    return torch.sum((lse - gold) * valid), torch.sum(valid)


def chunked_lm_loss(cfg: ModelConfig, params: Model, hidden: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 1024, mesh=None,
                    data_axes=("data",)) -> torch.Tensor:
    """Cross-entropy without materializing the full (B, S, V) float32
    logits: chunks of ``chunk`` positions (the last padded with label
    -1), the mean over the valid labels.  Each chunk's loss is
    checkpointed, so backward keeps one chunk's logits at a time and not
    every chunk's (the numbers are the same)."""
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    n = -(-S // chunk)
    pad = n * chunk - S
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        nll, count = _remat(_chunk_nll, cfg, params, hidden[:, sl],
                            labels[:, sl], mesh, data_axes)
        tot, cnt = tot + nll, cnt + count
    return tot / torch.clamp_min(cnt, 1.0)


def forward_train_loss(cfg: ModelConfig, params: Model, batch, *,
                       remat: bool = True, block_skip: bool = False,
                       remat_policy: str = "layer", mesh=None,
                       data_axes=("data",)):
    """The training loss: the LM loss over ``batch["labels"]`` plus the
    MoE aux loss.  Returns (loss, {"lm_loss", "aux_loss"})."""
    hidden, _, aux, _ = forward_hidden(cfg, params, batch, remat=remat,
                                       block_skip=block_skip,
                                       remat_policy=remat_policy, mesh=mesh,
                                       data_axes=data_axes)
    if cfg.family == "vlm":
        # loss on text tokens only; hidden includes the patch prefix
        hidden = hidden[:, batch["patch_embeds"].shape[1]:]
    loss = chunked_lm_loss(cfg, params, hidden, batch["labels"], mesh=mesh,
                           data_axes=data_axes)
    return loss + aux, {"lm_loss": loss, "aux_loss": aux}


# ---------------------------------------------------------------------------
# Serving: prefill
# ---------------------------------------------------------------------------

def _ring_align(cache_full: torch.Tensor, S: int, W: int) -> torch.Tensor:
    """Take the last W of S prefill K/V rows (axis 1) into ring-buffer slot
    order: position p goes to slot p % W."""
    return torch.roll(cache_full[:, S - W:S], shifts=(S - W) % W, dims=1)


def forward_prefill(cfg: ModelConfig, params: Model, batch, *,
                    block_skip: bool = False,
                    quantize_kv_cache: bool = False, mesh=None,
                    data_axes=("data",), moe_fsdp: bool = True):
    """Returns (last-token logits (B, V), decode cache dict)."""
    hidden, cache, _, _ = forward_hidden(cfg, params, batch,
                                         block_skip=block_skip,
                                         want_cache=True, mesh=mesh,
                                         data_axes=data_axes,
                                         moe_fsdp=moe_fsdp)
    logits = lm_head_logits(cfg, params.embed, params.lm_head, hidden[:, -1])
    S = hidden.shape[1]
    W = cfg.sliding_window
    if W and W < S and "k" in cache:
        for k in ("k", "v"):
            cache[k] = torch.stack([_ring_align(c, S, W) for c in cache[k]])
    if quantize_kv_cache and "k" in cache:
        kq, ks = attn.quantize_kv(cache["k"])
        vq, vs = attn.quantize_kv(cache["v"])
        cache.update(k=kq, v=vq, k_s=ks, v_s=vs)
    cache["pos"] = torch.tensor(S, dtype=torch.int32, device=hidden.device)
    return logits, cache


# ---------------------------------------------------------------------------
# Serving: decode
# ---------------------------------------------------------------------------

def kv_cache_bytes(cfg: ModelConfig, batch_size: int, max_seq: int) -> int:
    """bf16 K/V cache footprint, the reference's figure for choosing the
    int8 cache (0 for ssm and MLA)."""
    W = cfg.sliding_window
    S = min(max_seq, W) if W else max_seq
    if cfg.attn_free or cfg.mla.enabled:
        return 0
    return 2 * cfg.n_layers * batch_size * S * cfg.n_kv_heads \
        * cfg.d_head * 2


def init_decode_cache(cfg: ModelConfig, batch_size: int, max_seq: int,
                      dtype: torch.dtype | None = None, *,
                      quantize_kv_cache: bool = False,
                      device="cuda") -> dict:
    """Zero cache sized for ``max_seq`` positions (ring-buffered if
    windowed; an SSM's state does not grow with the sequence).
    ``quantize_kv_cache``: int8 K/V with per-token float32 scales."""
    dev = resolve_device(device)
    dt = dtype or param_dtype(cfg)
    L = cfg.n_layers
    cache = {"pos": torch.tensor(0, dtype=torch.int32, device=dev)}
    W = cfg.sliding_window
    S = min(max_seq, W) if W else max_seq

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.family in ("dense", "moe", "hybrid", "encdec", "vlm"):
        if cfg.mla.enabled:
            m = cfg.mla
            cache["ckv"] = zeros(L, batch_size, max_seq, m.kv_lora_rank)
            cache["krope"] = zeros(L, batch_size, max_seq,
                                   m.qk_rope_head_dim)
        else:
            kv_dt = torch.int8 if quantize_kv_cache else dt
            cache["k"] = zeros(L, batch_size, S, cfg.n_kv_heads, cfg.d_head,
                               dtype=kv_dt)
            cache["v"] = torch.zeros_like(cache["k"])
            if quantize_kv_cache:
                cache["k_s"] = zeros(L, batch_size, S, dtype=torch.float32)
                cache["v_s"] = torch.zeros_like(cache["k_s"])
    if cfg.family in ("ssm", "hybrid"):
        _, n_heads, conv_ch = ssm_mod.ssm_dims(cfg)
        cache["ssm"] = zeros(L, batch_size, n_heads, cfg.ssm.head_dim,
                             cfg.ssm.d_state, dtype=torch.float32)
        cache["conv"] = zeros(L, batch_size, cfg.ssm.d_conv - 1, conv_ch)
    if cfg.family == "encdec":
        enc_len = enc_len_for(cfg, max_seq)
        cache["xk"] = zeros(L, batch_size, enc_len, cfg.n_kv_heads,
                            cfg.d_head)
        cache["xv"] = torch.zeros_like(cache["xk"])
    return cache


# entries a decode step replaces (the SSM's), writes one slot of (the
# attention caches, copied first) or only reads (the cross-attention K/V)
_STATE_KEYS = ("ssm", "conv")
_READ_KEYS = ("xk", "xv")


def _decoder_layer_decode(cfg: ModelConfig, p: DecoderLayer, x, cache_l,
                          position, *, mesh=None, data_axes=("data",),
                          moe_fsdp: bool = True, moe_ep_data: bool = False):
    """One layer's decode step.  The attention caches in ``cache_l`` are
    written in place; the SSM state comes back new.  Returns (x, the
    layer's cache entries)."""
    new_cache = dict(cache_l)
    h = apply_norm(cfg, p.norm1, x)

    def self_attn():
        if "k_s" in cache_l:
            a_out, ck, cv, ks, vs = attn.gqa_decode(
                cfg, p.attn, h, cache_l["k"], cache_l["v"], position,
                k_scale=cache_l["k_s"], v_scale=cache_l["v_s"])
            new_cache.update(k_s=ks, v_s=vs)
        else:
            a_out, ck, cv = attn.gqa_decode(cfg, p.attn, h, cache_l["k"],
                                            cache_l["v"], position)
        new_cache.update(k=ck, v=cv)
        return a_out

    if cfg.family == "ssm":
        out, hT, conv = ssm_mod.ssm_decode(cfg, p.ssm, h, cache_l["ssm"],
                                           cache_l["conv"])
        new_cache.update(ssm=hT, conv=conv)
    elif cfg.family == "hybrid":
        a_out = self_attn()
        s_out, hT, conv = ssm_mod.ssm_decode(cfg, p.ssm, h, cache_l["ssm"],
                                             cache_l["conv"])
        out = (a_out + s_out) * 0.5
        new_cache.update(ssm=hT, conv=conv)
    elif cfg.mla.enabled:
        out, ckv, krope = attn.mla_decode(cfg, p.attn, h[:, 0:1],
                                          cache_l["ckv"], cache_l["krope"],
                                          position)
        new_cache.update(ckv=ckv, krope=krope)
    else:
        out = self_attn()
    x = x + out

    if cfg.family == "encdec":
        # the reference attends over every cross slot, at the RoPE
        # position of the last one
        hx = apply_norm(cfg, p.norm_x, x)
        xlast = torch.tensor(cache_l["xk"].shape[1] - 1, dtype=torch.int32,
                             device=x.device)
        out_x, _, _ = attn.gqa_decode(cfg, p.xattn, hx, cache_l["xk"],
                                      cache_l["xv"], xlast,
                                      update_cache=False)
        x = x + out_x

    if cfg.family == "moe":
        h2 = apply_norm(cfg, p.norm2, x)
        out2, _ = moe_forward(cfg, p.moe, h2, mesh=mesh, data_axes=data_axes,
                              fsdp=moe_fsdp, ep_data=moe_ep_data)
        x = x + out2
    elif cfg.d_ff > 0:
        h2 = apply_norm(cfg, p.norm2, x)
        x = x + apply_mlp(cfg, p.mlp, h2)
    return x, new_cache


def forward_decode(cfg: ModelConfig, params: Model, tokens: torch.Tensor,
                   cache: dict, *, mesh=None, data_axes=("data",),
                   moe_fsdp: bool = True, moe_ep_data: bool = False):
    """One decode step.  tokens: (B, 1) integer.  Returns (logits (B, V),
    new cache); the cache passed in is not modified: the attention caches
    are copied whole (one copy a step) and the new token written into the
    copy, the SSM state is made anew, the cross-attention K/V are
    shared."""
    position = cache["pos"]
    act_spec = P(tuple(data_axes), None, None)
    x = _constrain(embed_tokens(params.embed, tokens), mesh, act_spec)
    new = {}
    for k, t in cache.items():
        if k == "pos":
            continue
        new[k] = (torch.empty_like(t) if k in _STATE_KEYS
                  else t if k in _READ_KEYS else t.clone())
    for l, layer in enumerate(params.layers):
        cache_l = {k: (cache[k] if k in _STATE_KEYS else new[k])[l]
                   for k in new}
        x, out = _decoder_layer_decode(cfg, layer, x, cache_l, position,
                                       mesh=mesh, data_axes=data_axes,
                                       moe_fsdp=moe_fsdp,
                                       moe_ep_data=moe_ep_data)
        x = _constrain(x, mesh, act_spec)
        for k in _STATE_KEYS:
            if k in out:
                new[k][l] = out[k]
    x = apply_norm(cfg, params.final_norm, x)
    logits = lm_head_logits(cfg, params.embed, params.lm_head, x[:, 0])
    new["pos"] = position + 1
    return logits, new
