"""Deterministic synthetic LM data pipeline: a copy of the JAX package's
``repro/data/pipeline.py`` (numpy; its batches are bit-equal).

Produces a reproducible Zipf-ish token stream with local n-gram structure
(so the loss actually decreases when training), shifted labels, and
host-sharded loading: each host materializes only its slice of the global
batch — the pattern a 1000-node data pipeline needs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.config import ModelConfig, ShapeConfig


@dataclass
class SyntheticLMData:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1

    def __post_init__(self):
        assert self.global_batch % self.host_count == 0
        self.local_batch = self.global_batch // self.host_count

    def _sequence(self, rng: np.random.Generator) -> np.ndarray:
        """Zipf unigrams + a repeating motif so next-token is learnable."""
        v = self.vocab_size
        base = rng.zipf(1.3, size=self.seq_len + 1).clip(1, v - 1)
        motif = rng.integers(1, v, size=8)
        out = base.copy()
        for start in range(0, self.seq_len + 1 - 8, 24):
            out[start:start + 8] = motif
        return out.astype(np.int32)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        tokens = np.empty((self.local_batch, self.seq_len), np.int32)
        labels = np.empty_like(tokens)
        for i in range(self.local_batch):
            seq_id = step * self.global_batch \
                + self.host_index * self.local_batch + i
            rng = np.random.default_rng(self.seed * 1_000_003 + seq_id)
            s = self._sequence(rng)
            tokens[i] = s[:-1]
            labels[i] = s[1:]
        return {"tokens": tokens, "labels": labels}


def make_batch_iterator(cfg: ModelConfig, shape: ShapeConfig, *,
                        seed: int = 0, host_index: int = 0,
                        host_count: int = 1,
                        batch_override: Optional[int] = None,
                        ) -> Iterator[Dict[str, np.ndarray]]:
    data = SyntheticLMData(cfg.vocab_size, shape.seq_len,
                           batch_override or shape.global_batch,
                           seed=seed, host_index=host_index,
                           host_count=host_count)
    step = 0
    while True:
        b = data.batch(step)
        if cfg.family == "vlm":
            n_p = cfg.n_patches
            rng = np.random.default_rng(seed + step)
            b["patch_embeds"] = rng.normal(
                0, 1, (data.local_batch, n_p, cfg.d_model)).astype(np.float32)
            b["tokens"] = b["tokens"][:, : shape.seq_len - n_p]
            b["labels"] = b["labels"][:, : shape.seq_len - n_p]
        elif cfg.family == "encdec":
            from repro_torch.models.frontend import enc_len_for
            rng = np.random.default_rng(seed + step)
            b["frame_embeds"] = rng.normal(
                0, 1, (data.local_batch, enc_len_for(cfg, shape.seq_len),
                       cfg.d_model)).astype(np.float32)
        yield b
        step += 1
