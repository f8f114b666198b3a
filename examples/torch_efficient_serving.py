"""Energy-efficient serving on the PyTorch/CUDA port: batched decode with
the int8 KV cache and the roofline-coupled frequency plan (decode is the
framework's D-slash: memory bound, so the clock derates deeply at little
perf cost).  The JAX package's ``examples/efficient_serving.py``.

  PYTHONPATH=src python examples/torch_efficient_serving.py
  PYTHONPATH=src python examples/torch_efficient_serving.py --device cpu

Weights come from a seeded ``torch.Generator``; the prompt from numpy
seed 0.  The plan's watts are the H100 table's, modelled.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.config import (SINGLE_POD_MESH, EnergyConfig, ShapeConfig,
                                smoke_config)
from repro_torch.core.energy.dvfs import plan_frequency
from repro_torch.device import resolve_device
from repro_torch.models import forward_decode, forward_prefill, init_params
from repro_torch.power import H100_SXM
from repro_torch.roofline.analytic import cost_for


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = smoke_config("qwen1.5-32b")
    B, S, gen = 4, 64, 16
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S))).to(dev, torch.int32)}

    runs = {}
    for quant in (False, True):
        with torch.inference_mode():
            logits, cache = forward_prefill(cfg, params, batch,
                                            quantize_kv_cache=quant)
            tok = torch.argmax(logits[:, : cfg.vocab_size], dim=-1)[:, None]
            outs = []
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(gen):
                outs.append(tok)
                logits, cache = forward_decode(cfg, params,
                                               tok.to(torch.int32), cache)
                tok = torch.argmax(logits[:, : cfg.vocab_size],
                                   dim=-1)[:, None]
            _sync(dev)
            dt = time.perf_counter() - t0
        cache_mib = sum(v.numel() * v.element_size()
                        for k, v in cache.items() if k != "pos") / 2**20
        toks = torch.cat(outs, 1).cpu().numpy()
        runs[quant] = {"tok_s": gen * B / dt, "cache_mib": cache_mib,
                       "tokens": toks}
        print(f"kv_int8={quant}: {gen*B/dt:6.1f} tok/s, cache "
              f"{cache_mib:.2f} MiB, first tokens {toks[0][:6]}")

    # the energy plan for the config's decode cell at the full shape
    shape = ShapeConfig("serve", 32768, 128, "decode")
    ac = cost_for(cfg, shape, SINGLE_POD_MESH, kv_int8=True)
    plan = plan_frequency(ac.compute_s, ac.memory_s, ac.collective_s,
                          flops_per_step=ac.flops,
                          cfg=EnergyConfig(mode="efficiency"))
    print(f"\nfull-scale decode energy plan: dominant={plan.dominant} "
          f"freq={plan.freq_scale:.2f} power={plan.power_w:.0f}W "
          f"({H100_SXM.name}, modelled) perf_loss={plan.perf_loss:.2%}")
    return {"runs": runs, "plan": plan}


if __name__ == "__main__":
    main()
