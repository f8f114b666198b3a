"""qwen1.5-32b [dense] — 64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064.

QKV bias. [hf:Qwen/Qwen1.5-0.5B family config scaled; hf]
"""
from repro_torch.config import ModelConfig, register_arch

ARCH_ID = "qwen1.5-32b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        d_ff=27392,
        vocab_size=152064,
        qkv_bias=True,
        mlp_variant="swiglu",
        norm_variant="rmsnorm",
        source="hf:Qwen/Qwen1.5-32B",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=80,
        n_heads=5,
        n_kv_heads=5,
        d_ff=208,
        vocab_size=256,
        qkv_bias=True,
        mlp_variant="swiglu",
        norm_variant="rmsnorm",
        source="smoke",
    )


register_arch(ARCH_ID, full, smoke)
