"""mamba2-370m [ssm] — 48L d_model=1024, attention-free, vocab=50280.

SSD (state-space duality), ssm_state=128. [arXiv:2405.21060; unverified]
"""
from repro_torch.config import ModelConfig, SSMConfig, register_arch

ARCH_ID = "mamba2-370m"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      chunk_size=256),
        norm_variant="rmsnorm",
        tie_embeddings=True,
        source="arXiv:2405.21060",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      chunk_size=32),
        norm_variant="rmsnorm",
        tie_embeddings=True,
        source="smoke",
    )


register_arch(ARCH_ID, full, smoke)
