"""Automatic per-cell training memory plan: the counterpart of the JAX
package's ``repro/runtime/memplan.py``.

Chooses (microbatches, moment dtype, grad-accum dtype, remat policy) so the
step fits a per-device memory budget — the same decisions a production
launcher makes.  The byte counts are the reference's, term for term (its
estimate of the step's buffers per device of a mesh).  The budget is the
port's own: the reference keeps 12 GiB of a 16 GiB TPU chip, 75%; the port
keeps the same 75% of the H100's 80 GB (``roofline/hw.py``).  Pass
``budget=`` for another one.
"""
from __future__ import annotations

from dataclasses import replace

from repro_torch.config import (MeshConfig, ModelConfig, ShapeConfig,
                                TrainConfig)
from repro_torch.models.transformer import block_size
from repro_torch.roofline import hw
from repro_torch.roofline.analytic import layer_param_bytes

HBM_BUDGET = int(0.75 * hw.HBM_PER_CHIP)   # headroom below the 80 GB card


def estimate_train_bytes(cfg: ModelConfig, shape: ShapeConfig,
                         mesh_cfg: MeshConfig, tc: TrainConfig) -> int:
    """Bytes per device of one train step of ``shape`` on ``mesh_cfg``
    under ``tc``: parameters and moments, the gradients (double-buffered
    when accumulated), the stored residuals of the remat policy, and the
    transients of the largest layer, scaled by the reference's fudge
    factors."""
    chips = mesh_cfg.n_devices
    dp, tp = mesh_cfg.data_size, mesh_cfg.model_size
    N = cfg.param_count()
    mdt = 2 if tc.moment_dtype == "bfloat16" else 4
    gdt = 2 if tc.grad_accum_dtype == "bfloat16" else 4
    static = N * (2 + 2 * mdt) // chips           # params + m + v
    # grad accumulator double-buffers as a scan carry
    grads = N * gdt * 2 // chips if tc.microbatches > 1 else N * 4 // chips

    B, S = shape.global_batch, shape.seq_len
    T_loc = B * S // dp // tc.microbatches
    res = T_loc * cfg.d_model * 2                 # one residual, bf16
    L = cfg.n_layers
    if tc.remat == "block":
        bs = block_size(L)
        stored = (L // bs + bs) * res
    else:
        stored = L * res
    # per-layer transients live across the remat recompute window (inner
    # block): multiple activation-sized fp32/bf16 buffers coexist
    trans = 10 * res * 2
    if cfg.family != "ssm" and not cfg.mla.enabled:
        # blockwise attention: fp32 scores/accumulator blocks + stacked o
        o_bytes = T_loc * cfg.n_heads * cfg.d_head * 4 / tp
        sc_bytes = (T_loc / max(S // 512, 1)) * cfg.n_heads / tp * 512 * 4
        trans += 3 * o_bytes + 4 * sc_bytes
    if cfg.mla.enabled:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        trans += 4 * T_loc * cfg.n_heads * qk * 2 / tp
    if cfg.ssm.enabled:
        d_inner = cfg.ssm.expand * cfg.d_model
        in_dim = 2 * d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state \
            + d_inner // cfg.ssm.head_dim
        trans += 4 * T_loc * in_dim * 2           # proj/conv bf16 copies
        trans += 3 * T_loc * d_inner * 4          # gated-norm fp32 path
        Q = cfg.ssm.chunk_size
        Bl = max(T_loc // S, 1)
        trans += 2 * Bl * Q * Q * (d_inner // cfg.ssm.head_dim) * 4
    if cfg.moe.enabled:
        e = cfg.moe
        n_local = (e.n_experts // tp if e.n_experts % tp == 0
                   else e.n_experts)
        C = int(T_loc * e.top_k / e.n_experts * e.capacity_factor) + 1
        trans += 4 * (n_local + 1) * max(C, e.top_k) * cfg.d_model * 2
        trans += 2 * T_loc * e.top_k * cfg.d_model * 2
        trans += T_loc * cfg.d_model * 4          # fp32 combine
    # loss: fp32 logits chunk + lse buffers
    trans += 3 * (B // dp // tc.microbatches) * 1024 * cfg.vocab_padded \
        * 4 // tp
    if cfg.n_encoder_layers:
        enc_T = T_loc // cfg.encoder_ratio
        trans += cfg.n_encoder_layers * enc_T * cfg.d_model * 2
    # gathered layer weights (double buffered)
    trans += 2 * int(layer_param_bytes(cfg)) // tp
    fudge = 2.2 if cfg.ssm.enabled else 1.4
    return int(static + grads + stored + int(fudge * trans))


def auto_train_plan(cfg: ModelConfig, shape: ShapeConfig,
                    mesh_cfg: MeshConfig,
                    base: TrainConfig = TrainConfig(), *,
                    budget: int = HBM_BUDGET) -> TrainConfig:
    """The first plan, in the reference's order (float32 before bfloat16
    moments and accumulators, fewer microbatches first, sqrt-remat),
    whose ``estimate_train_bytes`` fits ``budget``; else the most
    frugal one."""
    dp = mesh_cfg.data_size
    B = shape.global_batch
    valid_m = [m for m in (1, 2, 4, 8, 16, 32, 64) if B % (m * dp) == 0]
    if not valid_m:
        valid_m = [1]
    for moment in ("float32", "bfloat16"):
        for ga in ("float32", "bfloat16"):
            for m in valid_m:
                tc = replace(base, microbatches=m, moment_dtype=moment,
                             grad_accum_dtype=ga, remat="block")
                if estimate_train_bytes(cfg, shape, mesh_cfg, tc) <= budget:
                    return tc
    return replace(base, microbatches=valid_m[-1], moment_dtype="bfloat16",
                   grad_accum_dtype="bfloat16", remat="block")
