"""Executed-group runtime: the port's prefill and decode steps behind the
replay engine's admission path (the counterpart of the JAX package's
``serve/executed.py``).

The analytic engine prices time and power; this hook makes the *model*
real: when attached (``ContinuousBatchingEngine(runtime=...)``), every
admitted prefill group runs :func:`repro_torch.runtime.steps.
make_prefill_step`, grows the decode cache to the full generation length
with :func:`~repro_torch.runtime.steps.grow_decode_cache` (as the
``launch.serve`` entry point does) and greedy-decodes the group with
:func:`~repro_torch.runtime.steps.make_decode_step`, storing each
request's generated tokens on its
:class:`~repro_torch.serve.engine.RequestRecord`.  On the card the steps
run the hand-written RMSNorm and SSD-chunk kernels; on the CPU their
plain versions.  Timing and energy on the records stay analytic
(deterministic, machine-independent); only the token content is
executed.  Each group's measured wall times are kept on
:attr:`ExecutedGroupRuntime.groups`, beside what the engine billed.

Token-only families (dense, moe, ssm, hybrid), with an int8 KV cache on
``kv_int8``; prompts are synthesized uniformly at random per group from
``np.random.default_rng(seed)``, as in the JAX package.
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, get_arch
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.runtime.steps import (grow_decode_cache, make_decode_step,
                                       make_prefill_step)


class ExecutedGroupRuntime:
    """Real prefill + cache-grow + decode for one admitted group.

    ``params`` (a :class:`repro_torch.models.transformer.Model` on
    ``device``) defaults to random weights from a ``torch.Generator``
    seeded with ``seed``.  ``device`` is the card unless the caller asks
    for ``"cpu"``.  ``cfg`` replaces ``arch``'s smoke or full
    configuration (a model cut in depth, say); the JAX class has no such
    argument."""

    def __init__(self, arch: str = "llama3-8b", *, smoke: bool = True,
                 kv_int8: bool = False, seed: int = 0,
                 params: Optional[torch.nn.Module] = None,
                 device="cuda", cfg: Optional[ModelConfig] = None):
        if cfg is None:
            entry = get_arch(arch)
            cfg = entry.smoke() if smoke else entry.full()
        self.cfg = cfg
        if self.cfg.family in ("vlm", "encdec"):
            raise ValueError(
                f"ExecutedGroupRuntime supports token-only families; "
                f"{arch!r} is {self.cfg.family!r}")
        self.kv_int8 = kv_int8
        self.device = resolve_device(device)
        self.params = params if params is not None else init_params(
            self.cfg, torch.Generator(self.device).manual_seed(seed),
            self.device)
        self._prefill = make_prefill_step(self.cfg,
                                          quantize_kv_cache=kv_int8)
        self._decode = make_decode_step(self.cfg)
        self._rng = np.random.default_rng(seed)
        #: one ``(prompt_len, n, gen_len, prefill_s, decode_s)`` per group:
        #: wall seconds of the prefill (with the cache grow) and of the
        #: ``gen_len`` decode steps
        self.groups: List[tuple] = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run_group(self, prompt_len: int, gen_len: int,
                  n: int) -> np.ndarray:
        """Prefill ``n`` random prompts of ``prompt_len`` tokens, grow
        the cache to ``prompt_len + gen_len``, greedy-decode
        ``gen_len`` tokens.  Returns an ``(n, gen_len)`` int32 array."""
        cfg, V = self.cfg, self.cfg.vocab_size
        tokens = torch.from_numpy(
            self._rng.integers(0, V, (n, prompt_len))).to(self.device,
                                                          torch.int32)
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, {"tokens": tokens})
        cache = grow_decode_cache(cfg, cache, n, prompt_len + gen_len,
                                  quantize_kv_cache=self.kv_int8)
        self._sync()
        t1 = time.perf_counter()
        out = []
        tok = torch.argmax(logits[:, :V], dim=-1)[:, None].to(torch.int32)
        for _ in range(gen_len):
            out.append(tok)
            logits, cache = self._decode(self.params, tok, cache)
            tok = torch.argmax(logits[:, :V], dim=-1)[:, None].to(
                torch.int32)
        self._sync()
        self.groups.append((prompt_len, n, gen_len, t1 - t0,
                            time.perf_counter() - t1))
        return torch.cat(out, dim=1).cpu().numpy()
