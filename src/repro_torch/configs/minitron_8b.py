"""minitron-8b [dense] — 32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.

Pruned Nemotron: squared-ReLU MLP (non-gated), huge vocab.
[arXiv:2407.14679; hf]
"""
from repro_torch.config import ModelConfig, register_arch

ARCH_ID = "minitron-8b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=256000,
        mlp_variant="relu2",
        norm_variant="layernorm",
        source="arXiv:2407.14679",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        mlp_variant="relu2",
        norm_variant="layernorm",
        source="smoke",
    )


register_arch(ARCH_ID, full, smoke)
