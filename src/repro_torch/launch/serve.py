"""Serving entry point: prefill, then batched greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --full --batch 4 --prompt-len 2048 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --device cpu

The flags of the JAX package's ``repro.launch.serve`` plus ``--device``
(default ``cuda``).  It prints the prefill time, the decode rate and the
sample tokens.  It prints no energy lines: those come from the TPU power
model (ROADMAP A3, A7).  Trace replay (``--replay``, ``--make-demo-trace``)
and the int8 KV cache (``--kv-int8``) are not ported yet and raise.
Weights are random, from a seeded ``torch.Generator``; the prompt comes
from numpy seed 0, as in the JAX package's serve CLI.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import ARCH_IDS, get_arch
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.runtime.steps import (grow_decode_cache, make_decode_step,
                                       make_prefill_step)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="mamba2-370m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--replay", metavar="PATH", default=None)
    ap.add_argument("--executed", action="store_true")
    ap.add_argument("--slo-s", type=float, default=None)
    ap.add_argument("--make-demo-trace", metavar="PATH", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.make_demo_trace or args.replay or args.executed or args.slo_s:
        raise NotImplementedError(
            "trace replay (--replay, --executed, --slo-s, --make-demo-trace) "
            "is not ported yet: ROADMAP A7 (serve/trace, engine, stats) and "
            "A6 (serve/executed.py)")
    if args.kv_int8:
        raise NotImplementedError(
            "--kv-int8 quantizes an attention KV cache, which the port does "
            "not have yet: ROADMAP A6 (attention families)")

    dev = resolve_device(args.device)
    entry = get_arch(args.arch)
    cfg = entry.smoke() if args.smoke else entry.full()
    B, S = args.batch, args.prompt_len
    total = S + args.gen

    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).to(dev, torch.int32)}
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    cache = grow_decode_cache(cfg, cache, B, total)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    print(f"prefill {S} tokens x {B}: {t_prefill:.2f}s")

    out_tokens = []
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(args.gen):
        out_tokens.append(tok)
        logits, cache = decode(params, tok.to(torch.int32), cache)
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
    _sync(dev)
    dt = time.perf_counter() - t0
    gen = torch.cat(out_tokens, dim=1).cpu().numpy()
    print(f"decoded {args.gen} tokens x {B} in {dt:.2f}s "
          f"({args.gen * B / dt:.1f} tok/s)")
    print("sample:", gen[0][:16])


if __name__ == "__main__":
    main()
