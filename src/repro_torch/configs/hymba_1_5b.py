"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001.

Parallel attention + mamba heads in every layer; ssm_state=16; sliding-window
attention makes 500k decode sub-quadratic. [arXiv:2411.13676; hf]
"""
from repro_torch.config import ModelConfig, SSMConfig, register_arch

ARCH_ID = "hymba-1.5b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_head=64,
        d_ff=5504,
        vocab_size=32001,
        sliding_window=2048,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                      chunk_size=256),
        mlp_variant="swiglu",
        norm_variant="rmsnorm",
        source="arXiv:2411.13676",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_head=16,
        d_ff=160,
        vocab_size=256,
        sliding_window=32,
        ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16,
                      chunk_size=16),
        mlp_variant="swiglu",
        norm_variant="rmsnorm",
        source="smoke",
    )


register_arch(ARCH_ID, full, smoke)
