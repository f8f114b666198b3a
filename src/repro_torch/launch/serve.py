"""Serving entry point: prefill, then batched greedy decode, or a
recorded-trace replay through the continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --full --batch 4 --prompt-len 2048 --gen 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --device cpu --kv-int8

Replay a recorded (or synthesized) request trace instead:

  PYTHONPATH=src python -m repro_torch.launch.serve --make-demo-trace day.npz
  PYTHONPATH=src python -m repro_torch.launch.serve --replay day.npz
  PYTHONPATH=src python -m repro_torch.launch.serve --replay day.npz \\
      --executed --device cpu

The flags of the JAX package's ``repro.launch.serve`` plus ``--device``
(default ``cuda``).  A model run serves every architecture (``--kv-int8``
with an int8 KV cache) and prints, as the reference does, the energy
plan, the prefill time, the decode rate, three ``[energy]`` lines and the
sample tokens.  Its watts and joules are modelled: the decode-shape DVFS
plan of ``ServeWorkload`` priced at an H100 SXM's table, over the
measured walls; no watts are read from the card.  Weights are random,
from a seeded ``torch.Generator``; the prompt, and the vlm patch or
audio frame embeddings, come from numpy seed 0 in the JAX package's
order.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.cluster.workload import ServeWorkload
from repro_torch.config import ARCH_IDS, get_arch
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.models.frontend import enc_len_for
from repro_torch.power.trace import TraceRecorder
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


def make_batch(cfg, batch_size: int, prompt_len: int, device) -> dict:
    """The prompt, and the vlm patch or audio frame embeddings (bfloat16),
    drawn from numpy seed 0 in the JAX package's order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    B, S = batch_size, prompt_len
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).to(dev, torch.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = torch.from_numpy(
            rng.normal(0, 1, (B, cfg.n_patches, cfg.d_model))).to(
                dev, torch.bfloat16)
    elif cfg.family == "encdec":
        batch["frame_embeds"] = torch.from_numpy(
            rng.normal(0, 1, (B, enc_len_for(cfg, S), cfg.d_model))).to(
                dev, torch.bfloat16)
    return batch


@dataclass
class Generation:
    """One batched generation: the greedy tokens (B, gen), the last
    step's logits (B, vocab_padded) and cache, and the host-clock seconds
    of the prefill (with the cache grow) and of the decode steps."""

    tokens: torch.Tensor
    logits: torch.Tensor
    cache: dict
    prefill_s: float
    decode_s: float


def generate(cfg, params, batch: dict, gen: int, *,
             kv_int8: bool = False) -> Generation:
    """The model run: prefill ``batch``, grow the cache to the prompt (the
    vlm patches included) plus ``gen`` positions, then ``gen`` greedy
    decode steps; each phase timed on the host clock up to a device
    synchronisation."""
    B, S = batch["tokens"].shape
    total = S + gen + (batch["patch_embeds"].shape[1]
                       if "patch_embeds" in batch else 0)
    dev = batch["tokens"].device
    prefill = make_prefill_step(cfg, quantize_kv_cache=kv_int8)
    decode = make_decode_step(cfg)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    cache = grow_decode_cache(cfg, cache, B, total, quantize_kv_cache=kv_int8)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    out_tokens = []
    tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
    t0 = time.perf_counter()
    for _ in range(gen):
        out_tokens.append(tok)
        logits, cache = decode(params, tok.to(torch.int32), cache)
        tok = torch.argmax(logits[:, :cfg.vocab_size], dim=-1)[:, None]
    _sync(dev)
    return Generation(torch.cat(out_tokens, dim=1), logits, cache, t_prefill,
                      time.perf_counter() - t0)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3-8b")
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
    dev = resolve_device(args.device)
    entry = get_arch(args.arch)
    cfg = entry.smoke() if args.smoke else entry.full()
    B, S = args.batch, args.prompt_len
    batch = make_batch(cfg, B, S, dev)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)

    # the energy plan (decode is memory-bound: a deep clock derate), from
    # the same Workload adapter the cluster scheduler uses; ac is the
    # per-decode-step cost, ac_prefill the prefill-shape cost
    workload = ServeWorkload(arch=args.arch, batch=B, prompt_len=S,
                             gen=args.gen, smoke=args.smoke,
                             kv_int8=args.kv_int8)
    plan, ac_prefill, ac = workload.energy_plan()
    print(f"[energy] decode dominant={plan.dominant} "
          f"freq={plan.freq_scale:.2f} power={plan.power_w:.0f}W "
          f"({workload.chip.name}, modelled)")

    run = generate(cfg, params, batch, args.gen, kv_int8=args.kv_int8)
    t_prefill, dt = run.prefill_s, run.decode_s
    print(f"prefill {S} tokens x {B}: {t_prefill:.2f}s")
    print(f"decoded {args.gen} tokens x {B} in {dt:.2f}s "
          f"({args.gen * B / dt:.1f} tok/s)")
    # the telemetry bus: the plan's watts over the prefill and the decode
    recorder = TraceRecorder(source="launch.serve")
    recorder.emit(0.0, {"chip": plan.power_w}, flops_rate=0.0,
                  freq_scale=plan.freq_scale)
    recorder.emit(t_prefill, {"chip": plan.power_w},
                  flops_rate=ac_prefill.flops / max(t_prefill, 1e-9) / 1e9,
                  freq_scale=plan.freq_scale)
    recorder.emit(t_prefill + dt, {"chip": plan.power_w},
                  flops_rate=ac.flops * args.gen / max(dt, 1e-9) / 1e9,
                  freq_scale=plan.freq_scale)
    trace = recorder.trace()
    # the bus energy split at the prefill/decode boundary, over the tokens
    # each phase processed (B·S prompt tokens, B·gen generated tokens)
    e_pre = trace.energy_j(0.0, t_prefill)
    e_dec = trace.energy_j(t_prefill, t_prefill + dt)
    n_pre, n_dec = B * S, B * args.gen
    print(f"[energy] prefill {e_pre:.1f} J / {n_pre} prompt tokens "
          f"= {e_pre / max(n_pre, 1):.3f} J/token")
    print(f"[energy] decode  {e_dec:.1f} J / {n_dec} generated tokens "
          f"= {e_dec / max(n_dec, 1):.3f} J/token")
    print(f"[energy] total   {trace.energy_j():.1f} J over "
          f"{trace.duration:.2f}s "
          f"({trace.energy_j() / max(n_pre + n_dec, 1):.3f} J/token over "
          f"all processed tokens)")
    print("sample:", run.tokens[0, :16].cpu().numpy())


if __name__ == "__main__":
    main()
