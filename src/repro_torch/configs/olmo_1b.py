"""olmo-1b [dense] — 16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.

Non-parametric LayerNorm (no learnable scale/bias), tied embeddings.
[arXiv:2402.00838; hf]
"""
from repro_torch.config import ModelConfig, register_arch

ARCH_ID = "olmo-1b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=50304,
        mlp_variant="swiglu",
        norm_variant="nonparametric_ln",
        tie_embeddings=True,
        source="arXiv:2402.00838",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=256,
        mlp_variant="swiglu",
        norm_variant="nonparametric_ln",
        tie_embeddings=True,
        source="smoke",
    )


register_arch(ARCH_ID, full, smoke)
