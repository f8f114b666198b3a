"""First-principles per-step cost model (FLOPs / HBM bytes / wire bytes),
a copy of the JAX package's ``roofline/analytic.py``.

Why this exists: the JAX package's dry run reads XLA's HLO cost analysis,
which counts a ``while``-loop body ONCE, so any scanned program (layers,
microbatches, attention chunks) is undercounted by the trip count.  The
roofline terms come from this model instead — napkin math parameterized
by the sharding and the remat/microbatch plan of the step.  In the port
it prices the ``train`` and ``serve`` workloads and the replay engine's
steps.

The counts are the reference's, unchanged.  The time terms divide them
by a chip's rates (:class:`repro_torch.power.model.ChipTable`): the
H100 SXM's by default (``roofline/hw.py``), where the JAX package reads
its TPU v5e constants.

All outputs are PER CHIP PER STEP.  Conventions:
  T   total tokens in the global batch (B*S; decode: B)
  dp  data-parallel world (pod*data axes), tp model axis
  matmul FLOPs = 2*m*n*k; backward = 2x forward; remat adds recompute.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.config import (MeshConfig, ModelConfig, ShapeConfig,
                                TrainConfig)
from repro_torch.models.frontend import enc_len_for
from repro_torch.power.model import H100_SXM, ChipTable


@dataclass
class AnalyticCost:
    flops: float                   # per chip
    hbm_bytes: float               # per chip
    ici_bytes: float               # per chip (wire)
    dcn_bytes: float               # per chip (wire)
    detail: Dict[str, float]
    chip: ChipTable = field(default=H100_SXM, repr=False)

    @property
    def compute_s(self) -> float:
        return self.flops / self.chip.peak_bf16_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / self.chip.hbm_bw

    @property
    def collective_s(self) -> float:
        return (self.ici_bytes / self.chip.link_bw
                + self.dcn_bytes / self.chip.dcn_bw)


def _attn_dims(cfg: ModelConfig):
    if cfg.mla.enabled:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return qk, m.v_head_dim
    return cfg.d_head, cfg.d_head


def layer_param_bytes(cfg: ModelConfig) -> float:
    """Per-layer parameter bytes (bf16)."""
    body = (cfg.param_count()
            - cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2))
    layers = cfg.n_layers + cfg.n_encoder_layers
    return 2.0 * body / max(layers, 1)


def _attn_flops_fwd(cfg: ModelConfig, T: float, S_kv: float,
                    causal_factor: float) -> float:
    """Projections + scores/AV for T query tokens against S_kv keys."""
    d = cfg.d_model
    qk, vd = _attn_dims(cfg)
    H, KVH = cfg.n_heads, cfg.n_kv_heads
    if cfg.mla.enabled:
        m = cfg.mla
        f = 0.0
        f += 2 * T * d * m.q_lora_rank                      # q down
        f += 2 * T * m.q_lora_rank * H * qk                 # q up
        f += 2 * T * d * (m.kv_lora_rank + m.qk_rope_head_dim)
        f += 2 * T * m.kv_lora_rank * H * (m.qk_nope_head_dim + vd)
        f += 2 * T * H * vd * d                             # out
    else:
        f = 2 * T * d * (H + 2 * KVH) * cfg.d_head          # qkv proj
        f += 2 * T * H * cfg.d_head * d                     # out proj
    win = cfg.sliding_window
    eff_kv = min(S_kv, win) if win else S_kv
    f += 2 * 2 * T * eff_kv * H * qk * causal_factor        # scores + AV
    return f


def _ssm_flops_fwd(cfg: ModelConfig, T: float) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    H = di // s.head_dim
    P, N, Q = s.head_dim, s.d_state, s.chunk_size
    in_dim = 2 * di + 2 * s.n_groups * N + H
    f = 2 * T * d * in_dim + 2 * T * di * d                 # in/out proj
    f += 2 * T * s.d_conv * (di + 2 * s.n_groups * N)       # conv
    # SSD: intra-chunk (CB^T: Q*N per pair; weighted AV: Q*P) + states
    f += 2 * T * Q * s.n_groups * N                         # C·B within chunk
    f += 2 * T * Q * H * P * 0.5                            # masked AV
    f += 2 * 2 * T * H * P * N                              # state in/out
    return f


def _mlp_flops_fwd(cfg: ModelConfig, T: float) -> float:
    if cfg.moe.enabled:
        e = cfg.moe
        f = 2 * T * cfg.d_model * e.n_experts               # router
        slots = e.top_k * e.capacity_factor                 # per token
        nmat = 3 if cfg.mlp_variant in ("swiglu", "geglu") else 2
        f += nmat * 2 * T * slots * cfg.d_model * e.expert_d_ff
        f += (e.n_shared_experts * nmat * 2 * T * cfg.d_model
              * e.expert_d_ff)
        return f
    if cfg.d_ff == 0:
        return 0.0
    nmat = 3 if cfg.mlp_variant in ("swiglu", "geglu") else 2
    return nmat * 2 * T * cfg.d_model * cfg.d_ff


def forward_flops(cfg: ModelConfig, B: int, S: int, S_kv: float,
                  causal_factor: float) -> float:
    """Total forward FLOPs across the cluster for B sequences of S tokens
    attending to S_kv history."""
    T = float(B) * S
    per_layer = 0.0
    if cfg.family != "ssm":
        per_layer += _attn_flops_fwd(cfg, T, S_kv, causal_factor)
    if cfg.family in ("ssm", "hybrid"):
        per_layer += _ssm_flops_fwd(cfg, T)
    per_layer += _mlp_flops_fwd(cfg, T)
    total = cfg.n_layers * per_layer
    if cfg.family == "encdec":
        T_enc = float(B) * enc_len_for(cfg, S)
        enc_layer = (_attn_flops_fwd(
            cfg, T_enc, enc_len_for(cfg, S), 1.0)
            + _mlp_flops_fwd(cfg, T_enc))
        total += cfg.n_encoder_layers * enc_layer
        # decoder cross-attention: q/out for T, kv for T_enc, scores T x enc
        d, dh, H, KVH = cfg.d_model, cfg.d_head, cfg.n_heads, cfg.n_kv_heads
        total += cfg.n_layers * (
            2 * T * d * (H + 0) * dh + 2 * T * H * dh * d
            + 2 * T_enc * d * 2 * KVH * dh
            + 2 * 2 * T * enc_len_for(cfg, S) * H * dh)
    total += 2 * T * cfg.d_model * cfg.vocab_padded          # lm head
    return total


REMAT_EXTRA = {"none": 0.0, "layer": 1.0, "block": 2.0}


def train_cost(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
               tc: TrainConfig, *, block_skip: bool = False) -> AnalyticCost:
    B, S = shape.global_batch, shape.seq_len
    chips = mesh_cfg.n_devices
    dp = mesh_cfg.data_size
    tp = mesh_cfg.model_size
    M = tc.microbatches
    causal = 0.55 if block_skip else 1.0      # triangular scan ~ (nq+1)/2nq

    fwd = forward_flops(cfg, B, S, S, causal)
    extra = REMAT_EXTRA.get(tc.remat, 1.0)
    flops_total = fwd * (3.0 + extra)
    flops_chip = flops_total / chips

    # ---- HBM traffic per chip --------------------------------------------
    pbytes = 2.0 * cfg.param_count()          # bf16, cluster-total
    pbytes_tp = pbytes / tp                   # per chip after FSDP gather
    n_passes = (2.0 + extra) * M              # fwd + bwd + recompute, per mb
    w_traffic = pbytes_tp * n_passes          # gathered weights read
    mdt = 2.0 if tc.moment_dtype == "bfloat16" else 4.0
    opt_traffic = (cfg.param_count() / chips) * (2 * mdt * 2 + 4 + 2 + 2)
    # m,v read+write; grad read fp32; param read+write bf16
    T_loc = float(B) * S / dp / M
    act = T_loc * cfg.d_model * 2.0           # one residual, bf16
    act_traffic_layer = 8.0 * act             # in/out + norms + proj I/O
    if cfg.family != "ssm":
        # blockwise attention re-reads K/V once per q-chunk pass
        qk, _ = _attn_dims(cfg)
        win = cfg.sliding_window or S
        kv_bytes = T_loc * cfg.n_kv_heads * cfg.d_head * 2 * 2
        n_q_passes = max(min(S, win) // 512, 1)
        act_traffic_layer += kv_bytes / tp * n_q_passes * 0.25
    act_traffic = (act_traffic_layer * cfg.n_layers * M * (2.0 + extra)
                   / max(tp, 1) ** 0)         # activations not TP-sharded
    hbm = w_traffic + opt_traffic + act_traffic

    # ---- Collectives ------------------------------------------------------
    lw = layer_param_bytes(cfg) / tp          # per-chip gathered layer bytes
    L = cfg.n_layers + cfg.n_encoder_layers
    gathers = (1.0 + extra) * M + 1.0         # fwd(+recompute) AG + bwd AG
    ag = L * lw * (dp - 1) / dp * gathers
    rs = L * (lw * 2) * (dp - 1) / dp * M     # fp32 grad reduce-scatter
    act_bytes = T_loc * cfg.d_model * 2.0
    ar_per_layer = 2.0 * (2.0 * act_bytes * (tp - 1) / tp)  # 2 ARs (attn+mlp)
    tp_ar = L * ar_per_layer * M * (2.0 + extra)
    if cfg.moe.enabled:
        tp_ar += cfg.n_layers * 2.0 * (T_loc * cfg.d_model * 4.0) \
            * (tp - 1) / tp * M * (2.0 + extra)
    wire = ag + rs + tp_ar
    ici, dcn = wire, 0.0
    if mesh_cfg.multi_pod:
        pod = mesh_cfg.shape[0]
        # share of dp hops crossing pods
        frac = (pod - 1) / pod / (dp - 1) * dp
        dcn = (ag + rs) * min(frac, 1.0) * 0.5
        ici = wire - dcn
    return AnalyticCost(flops_chip, hbm, ici, dcn, {
        "fwd_flops_total": fwd, "weight_traffic": w_traffic,
        "opt_traffic": opt_traffic, "act_traffic": act_traffic,
        "fsdp_ag": ag, "grad_rs": rs, "tp_ar": tp_ar})


def prefill_cost(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
                 *, block_skip: bool = False,
                 serve_tp_only: bool = True) -> AnalyticCost:
    B, S = shape.global_batch, shape.seq_len
    chips = mesh_cfg.n_devices
    dp, tp = mesh_cfg.data_size, mesh_cfg.model_size
    causal = 0.55 if block_skip else 1.0
    fwd = forward_flops(cfg, B, S, S, causal)
    flops_chip = fwd / chips

    pbytes_tp = 2.0 * cfg.param_count() / tp
    T_loc = float(B) * S / dp
    act_traffic = 8.0 * T_loc * cfg.d_model * 2.0 * cfg.n_layers
    cache_write = _cache_bytes(cfg, B, S) / chips
    hbm = pbytes_tp + act_traffic + cache_write

    L = cfg.n_layers + cfg.n_encoder_layers
    act_bytes = T_loc * cfg.d_model * 2.0
    wire = L * 2.0 * (2.0 * act_bytes * (tp - 1) / tp)
    if not serve_tp_only:
        wire += L * (layer_param_bytes(cfg) / tp) * (dp - 1) / dp
    ici, dcn = wire, 0.0
    if mesh_cfg.multi_pod:
        dcn = wire * 0.1
        ici = wire - dcn
    return AnalyticCost(flops_chip, hbm, ici, dcn,
                        {"fwd_flops_total": fwd,
                         "cache_write": cache_write})


def _cache_bytes(cfg: ModelConfig, B: int, S: int,
                 kv_int8: bool = False) -> float:
    total = 0.0
    L = cfg.n_layers
    W = cfg.sliding_window
    S_eff = min(S, W) if W else S
    if cfg.family != "ssm":
        if cfg.mla.enabled:
            m = cfg.mla
            total += L * B * S * (m.kv_lora_rank + m.qk_rope_head_dim) * 2
        else:
            per_elem = 1 if kv_int8 else 2
            total += 2 * L * B * S_eff * cfg.n_kv_heads * cfg.d_head \
                * per_elem
            if kv_int8:
                total += 2 * L * B * S_eff * cfg.n_kv_heads * 4  # scales
    if cfg.family in ("ssm", "hybrid"):
        di = cfg.ssm.expand * cfg.d_model
        H = di // cfg.ssm.head_dim
        total += L * B * H * cfg.ssm.head_dim * cfg.ssm.d_state * 4
        total += L * B * (cfg.ssm.d_conv - 1) * (
            di + 2 * cfg.ssm.n_groups * cfg.ssm.d_state) * 2
    if cfg.family == "encdec":
        total += 2 * L * B * enc_len_for(cfg, S) * cfg.n_kv_heads \
            * cfg.d_head * 2
    return total


def decode_cost(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
                *, serve_tp_only: bool = True,
                kv_int8: bool = False, moe_ep: bool = False,
                replicas: int = 1) -> AnalyticCost:
    """``moe_ep``: experts resident over the data axes (no weight gathers);
    ``replicas > 1``: replica-parallel serving — the mesh runs ``replicas``
    independent copies of the model, each on chips/replicas devices (the
    right-sizing fix for tiny-batch long-context streams)."""
    B, S = shape.global_batch, shape.seq_len
    chips = mesh_cfg.n_devices // replicas
    dp = max(mesh_cfg.data_size // replicas, 1)
    tp = mesh_cfg.model_size if replicas == 1 else max(
        mesh_cfg.n_devices // replicas // dp, 1)
    fwd = forward_flops(cfg, B, 1, S, 1.0)
    flops_chip = fwd / chips

    active_b = 2.0 * cfg.active_param_count()
    if moe_ep:
        # fully resident: dense part over tp, experts over all chips
        dense_b = 2.0 * (cfg.active_param_count()
                         - cfg.n_layers * cfg.moe.n_experts * 0)
        weight_read = 2.0 * cfg.param_count() / chips \
            + (active_b - 2.0 * cfg.param_count() / chips * 0) * 0
        weight_read = 2.0 * cfg.param_count() / chips
    else:
        weight_read = active_b / tp
    # cache read once; write is only the new token's K/V (tiny)
    cache_rw = _cache_bytes(cfg, B, S, kv_int8) / chips * 1.02
    hbm = weight_read + cache_rw + 4.0 * float(B) / dp * cfg.d_model * 2 \
        * cfg.n_layers

    L = cfg.n_layers
    act_bytes = float(B) / dp * cfg.d_model * 2.0
    wire = L * 2.0 * (2.0 * act_bytes * (tp - 1) / tp)
    # softmax reductions over the seq-sharded cache: ~3 scalars/head/token
    wire += L * 3.0 * float(B) / dp * cfg.n_heads * 4.0 * 2 * (tp - 1) / tp
    if moe_ep:
        # token AG over data + output RS over data + psum over model
        tok = float(B) * cfg.d_model * 2.0
        wire += L * (2.0 * tok * (dp - 1) / dp
                     + 2.0 * tok * (tp - 1) / tp)
    elif not serve_tp_only:
        wire += L * (layer_param_bytes(cfg) / tp) * (dp - 1) / dp
    ici, dcn = wire, 0.0
    if mesh_cfg.multi_pod and replicas == 1:
        dcn = wire * 0.1
        ici = wire - dcn
    return AnalyticCost(flops_chip, hbm, ici, dcn,
                        {"fwd_flops_total": fwd, "weight_read": weight_read,
                         "cache_rw": cache_rw, "replicas": replicas})


def cost_for(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
             tc: Optional[TrainConfig] = None, *, block_skip: bool = False,
             serve_tp_only: bool = True,
             kv_int8: bool = False, moe_ep: bool = False,
             replicas: int = 1, chip: ChipTable = H100_SXM) -> AnalyticCost:
    """The step's cost, its times priced at ``chip``'s rates."""
    if shape.kind == "train":
        ac = train_cost(cfg, shape, mesh_cfg, tc or TrainConfig(),
                        block_skip=block_skip)
    elif shape.kind == "prefill":
        ac = prefill_cost(cfg, shape, mesh_cfg, block_skip=block_skip,
                          serve_tp_only=serve_tp_only)
    else:
        ac = decode_cost(cfg, shape, mesh_cfg, serve_tp_only=serve_tp_only,
                         kv_int8=kv_int8, moe_ep=moe_ep, replicas=replicas)
    ac.chip = chip
    return ac
