"""Time the port's serve prefill on one card: an architecture at its
published widths (seeded random weights; llama3-8b by default), a batch
of prompts through ``make_prefill_step``, ``--reps`` warm prefills after
one warm-up, each on the host clock ending in a synchronise.  Prints one
JSON line with the card's name and power limit, every prefill's
milliseconds, their median and minimum.

  PYTHONPATH=src python benchmarks/torch_prefill.py [--arch A] \\
      [--batch B] [--prompt S] [--reps N]

It imports only ``repro_torch``, so to compare two trees of the port run
it with each tree's ``src`` first on ``PYTHONPATH``, in turns (A, B, B,
A) in one session on one card.
"""
import argparse
import json
import statistics
import subprocess
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    import repro_torch
    from repro_torch.config import full_config
    from repro_torch.launch.serve import make_batch
    from repro_torch.models import init_params
    from repro_torch.runtime.steps import make_prefill_step

    if not torch.cuda.is_available():
        raise SystemExit("torch_prefill: no CUDA device is available")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = full_config(args.arch)
    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    batch = make_batch(cfg, args.batch, args.prompt, dev)
    prefill = make_prefill_step(cfg)
    prefill(params, batch)
    ms = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"card": card, "package": repro_torch.__file__,
                      "arch": args.arch, "batch": args.batch,
                      "prompt": args.prompt, "prefill_ms": ms,
                      "median_ms": statistics.median(ms),
                      "min_ms": min(ms)}))


if __name__ == "__main__":
    main()
