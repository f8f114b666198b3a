"""Quickstart on the PyTorch/CUDA port: train a small LM for 40 steps,
then greedy-decode from it (the JAX package's ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py              # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The train step updates the model and the AdamW state in place.  Weights
come from a seeded ``torch.Generator``, so the numbers differ from the
JAX example's.
"""
import argparse

import torch

from repro_torch.config import ShapeConfig, TrainConfig, smoke_config
from repro_torch.data import make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.models import forward_decode, forward_prefill, init_params
from repro_torch.optim import adamw_init
from repro_torch.runtime.steps import make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = smoke_config("llama3-8b")
    shape = ShapeConfig("quick", 128, 8, "train")
    tc = TrainConfig(learning_rate=3e-3, total_steps=40, warmup_steps=4,
                     remat="none")

    params = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    opt = adamw_init(params)
    step = make_train_step(cfg, tc)
    data = make_batch_iterator(cfg, shape)

    print(f"training {cfg.name} on {dev}: "
          f"{sum(p.numel() for p in params.parameters()):,} params")
    losses = []
    for i in range(40):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(data).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        if i % 10 == 0 or i == 39:
            print(f"  step {i:3d}  loss {losses[-1]:.4f}")

    # generate a few tokens
    prompt = {"tokens": torch.from_numpy(
        next(data)["tokens"][:2, :16]).to(dev)}
    with torch.inference_mode():
        logits, cache = forward_prefill(cfg, params, prompt)
        toks = []
        tok = torch.argmax(logits[:, : cfg.vocab_size], dim=-1)[:, None]
        for _ in range(8):
            toks.append(int(tok[0, 0]))
            logits, cache = forward_decode(cfg, params,
                                           tok.to(torch.int32), cache)
            tok = torch.argmax(logits[:, : cfg.vocab_size], dim=-1)[:, None]
    print("generated:", toks)
    return {"losses": losses, "tokens": toks}


if __name__ == "__main__":
    main()
