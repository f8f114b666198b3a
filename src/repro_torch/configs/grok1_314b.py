"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072.

MoE: 8 experts, top-2 routing. [hf:xai-org/grok-1; unverified]
"""
from repro_torch.config import MoEConfig, ModelConfig, register_arch

ARCH_ID = "grok-1-314b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=64,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=32768,
        vocab_size=131072,
        moe=MoEConfig(n_experts=8, top_k=2, expert_d_ff=32768),
        mlp_variant="geglu",
        norm_variant="rmsnorm",
        source="hf:xai-org/grok-1",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=128),
        mlp_variant="geglu",
        norm_variant="rmsnorm",
        source="smoke",
    )


register_arch(ARCH_ID, full, smoke)
