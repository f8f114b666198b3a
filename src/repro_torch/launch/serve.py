"""Serving entry point: prefill, then batched greedy decode, or a
recorded-trace replay through the continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --full --batch 4 --prompt-len 2048 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --device cpu

Replay a recorded (or synthesized) request trace instead:

  PYTHONPATH=src python -m repro_torch.launch.serve --make-demo-trace day.npz
  PYTHONPATH=src python -m repro_torch.launch.serve --replay day.npz
  PYTHONPATH=src python -m repro_torch.launch.serve --replay day.npz \\
      --arch mamba2-370m --executed --device cpu

The flags of the JAX package's ``repro.launch.serve`` plus ``--device``
(default ``cuda``).  A model run prints the prefill time, the decode
rate and the sample tokens; it prints no energy lines (the replay prices
its steps and watts analytically, at an H100 SXM's rates).  The analytic
``--replay`` works for every architecture; the model runs (the plain
one, and ``--replay --executed``) run the ssm family only, and
``--kv-int8`` on a model run raises (ROADMAP A6).  Weights are random,
from a seeded ``torch.Generator``; the prompt comes from numpy seed 0, as
in the JAX package's serve CLI.
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


def _replay(args) -> None:
    """--replay: feed a RequestTrace through the analytic
    continuous-batching engine (optionally with executed token
    generation on ``--device``) and print the per-request serve
    report."""
    from repro_torch.serve import (ContinuousBatchingEngine,
                                   ExecutedGroupRuntime, RequestTrace,
                                   ServeCostModel)
    trace = RequestTrace.load(args.replay)
    print(f"[replay] {trace.n_requests} requests over "
          f"{trace.duration_s:.3g}s ({trace.meta.get('generator', '?')})")
    cost = ServeCostModel(args.arch, max_batch=args.batch,
                          prompt_len=args.prompt_len, gen=args.gen,
                          smoke=args.smoke, kv_int8=args.kv_int8)
    runtime = None
    if args.executed:
        runtime = ExecutedGroupRuntime(args.arch, smoke=args.smoke,
                                       kv_int8=args.kv_int8,
                                       device=args.device)
    engine = ContinuousBatchingEngine(cost, runtime=runtime)
    res = engine.replay(trace, slo_s=args.slo_s)
    print(f"[energy] decode dominant={res.plan.dominant} "
          f"freq={res.plan.freq_scale:.2f} power={res.plan.power_w:.0f}W "
          f"({cost.chip.name}, modelled)")
    print("[replay]", res.stats.summary())
    done = [r for r in res.records if r.done_s is not None]
    if done:
        r = done[0]
        print(f"[replay] request {r.idx}: wait {r.wait_s:.3g}s "
              f"ttft {r.ttft_s:.3g}s latency {r.latency_s:.3g}s "
              f"{res.request_energy_j(r.idx):.3g} J")
        if r.tokens is not None:
            print("sample:", np.asarray(r.tokens)[:16])


def _make_demo_trace(args) -> None:
    """--make-demo-trace: write a seeded diurnal day scaled to this
    serve shape's analytic capacity."""
    from repro_torch.serve import ServeCostModel, diurnal_trace
    cost = ServeCostModel(args.arch, max_batch=args.batch,
                          prompt_len=args.prompt_len, gen=args.gen,
                          smoke=args.smoke, kv_int8=args.kv_int8)
    plan, _, _ = cost.plan()
    t_pre, _ = cost.prefill_cost(args.prompt_len, args.batch)
    service_s = t_pre + args.gen * plan.step_time_s
    cap_rps = args.batch / service_s
    day = 512.0 * service_s
    tr = diurnal_trace(day, rate_peak_per_s=0.6 * cap_rps,
                       rate_floor_per_s=0.05 * cap_rps,
                       prompt_lens=(args.prompt_len,),
                       gen_lens=(args.gen,), seed=0)
    tr.save(args.make_demo_trace)
    print(f"[trace] wrote {tr.n_requests} requests over {day:.3g}s "
          f"to {args.make_demo_trace}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="mamba2-370m")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--replay", metavar="PATH", default=None,
                    help="replay a RequestTrace npz through the "
                         "continuous-batching engine instead of one "
                         "batched generation")
    ap.add_argument("--executed", action="store_true",
                    help="with --replay: run the model's prefill/decode "
                         "per admitted group on --device (tokens become "
                         "real; timing stays analytic)")
    ap.add_argument("--slo-s", type=float, default=None,
                    help="with --replay: p99 latency SLO for the "
                         "compliance report")
    ap.add_argument("--make-demo-trace", metavar="PATH", default=None,
                    help="write a seeded diurnal demo trace npz sized to "
                         "this serve shape, then exit")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.make_demo_trace:
        _make_demo_trace(args)
        return
    if args.replay:
        _replay(args)
        return
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
