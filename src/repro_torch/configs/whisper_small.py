"""whisper-small [audio] — 12L d_model=768 12H (GQA kv=12) d_ff=3072 vocab=51865.

Encoder-decoder; conv audio frontend is a STUB (input_specs() provides
precomputed frame embeddings, enc_len = dec_len / encoder_ratio).
[arXiv:2212.04356; unverified]
"""
from repro_torch.config import ModelConfig, register_arch

ARCH_ID = "whisper-small"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="encdec",
        n_layers=12,              # decoder layers
        n_encoder_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        d_ff=3072,
        vocab_size=51865,
        mlp_variant="gelu",
        norm_variant="layernorm",
        frontend="audio",
        encoder_ratio=4,
        tie_embeddings=True,
        source="arXiv:2212.04356",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="encdec",
        n_layers=2,
        n_encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        mlp_variant="gelu",
        norm_variant="layernorm",
        frontend="audio",
        encoder_ratio=4,
        tie_embeddings=True,
        source="smoke",
    )


register_arch(ARCH_ID, full, smoke)
