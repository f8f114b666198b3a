"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000.

Mistral-7B backbone; anyres vision tiling is a STUB (input_specs() provides
n_patches precomputed patch embeddings prepended to the text sequence).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""
from repro_torch.config import ModelConfig, register_arch

ARCH_ID = "llava-next-mistral-7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=32000,
        rope_theta=1_000_000.0,
        mlp_variant="swiglu",
        norm_variant="rmsnorm",
        frontend="vlm",
        n_patches=576,
        source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab_size=256,
        mlp_variant="swiglu",
        norm_variant="rmsnorm",
        frontend="vlm",
        n_patches=16,
        source="smoke",
    )


register_arch(ARCH_ID, full, smoke)
