"""llama3-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.

GQA with 128k vocab. [arXiv:2407.21783; unverified]
"""
from repro_torch.config import ModelConfig, register_arch

ARCH_ID = "llama3-8b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=500_000.0,
        mlp_variant="swiglu",
        norm_variant="rmsnorm",
        source="arXiv:2407.21783",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=256,
        rope_theta=500_000.0,
        mlp_variant="swiglu",
        norm_variant="rmsnorm",
        source="smoke",
    )


register_arch(ARCH_ID, full, smoke)
