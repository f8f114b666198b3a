"""deepseek-v2-236b [moe] — 60L d_model=5120 128H d_ff=1536 vocab=102400.

MLA kv_lora=512; MoE: 2 shared + 160 routed experts, top-6.
[arXiv:2405.04434; hf]
"""
from repro_torch.config import MLAConfig, MoEConfig, ModelConfig, register_arch

ARCH_ID = "deepseek-v2-236b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        d_ff=12288,            # dense-MLP d_ff of the first (non-MoE) layer class
        vocab_size=102400,
        moe=MoEConfig(n_experts=160, top_k=6, n_shared_experts=2,
                      expert_d_ff=1536),
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        mlp_variant="swiglu",
        norm_variant="rmsnorm",
        source="arXiv:2405.04434",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=2, n_shared_experts=1,
                      expert_d_ff=48),
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16),
        mlp_variant="swiglu",
        norm_variant="rmsnorm",
        source="smoke",
    )


register_arch(ARCH_ID, full, smoke)
