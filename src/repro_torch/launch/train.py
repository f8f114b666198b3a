"""Training driver: data pipeline -> train step -> checkpoints, with
energy accounting (the paper's technique) and fault tolerance: the JAX
package's ``repro.launch.train`` on PyTorch.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --smoke --steps 50 --batch 8 --seq 128 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --full --batch 4 --seq 2048 --steps 6 --ckpt-every 2

The flags of the JAX package's driver plus ``--device`` (default
``cuda``; without a card that raises unless ``--device cpu`` is passed).
It prints what the reference prints: the energy plan, a line per logged
step, ``[fault]`` lines, and the closing ``[energy]`` line with the
straggler report.  The watts are modelled: ``TrainWorkload``'s DVFS plan
priced at an H100 SXM's table, over the measured step walls.

Where it differs from the reference:

* the weights come from a seeded ``torch.Generator`` (``make_params``),
  so the numbers differ from the JAX package's;
* ``make_train_step`` updates the model and the AdamW state in place.
  The reference rolls a bad step back by dropping the new trees the step
  returned; here the tensors the step wrote must be written back.  So
  ``last_good`` is a copy of the parameters and the AdamW state (moments
  and step count) at the last checkpointed step, and while there is none
  yet, the state from before each step is copied, outside the step's
  timed wall, to undo that step.  One buffer holds either copy: the undo
  copy is needed only while there is no ``last_good``.  At mamba2-370m's
  full width it is ~3.7 GB on the device.  Past ``max_retries`` the bad
  step's result is kept, as in the reference.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.cluster.workload import TrainWorkload
from repro_torch.config import ARCH_IDS, ShapeConfig, TrainConfig, get_arch
from repro_torch.data import make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import FaultPolicy, FaultTolerantLoop
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.power.trace import PowerTrace, TraceRecorder
from repro_torch.runtime.steps import make_train_step


def make_params(cfg, seed: int, device):
    """The initial weights: ``init_params`` drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed``."""
    dev = resolve_device(device)
    return init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)


def _state(params, opt) -> list:
    """Every tensor a train step writes, in a fixed order."""
    return [*params.parameters(), *opt["m"].values(), *opt["v"].values(),
            opt["step"]]


@torch.no_grad()
def _snapshot(params, opt, into: list | None) -> list:
    """A copy of the train state, into ``into``'s tensors when given."""
    if into is None:
        return [t.detach().clone() for t in _state(params, opt)]
    for d, s in zip(into, _state(params, opt)):
        d.copy_(s)
    return into


@torch.no_grad()
def _write_back(params, opt, snap: list) -> None:
    for d, s in zip(_state(params, opt), snap):
        d.copy_(s)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class TrainRun:
    """What a run ends with: the model and AdamW state, the fault loop
    (its history holds each step's wall and loss), the checkpoint manager
    and the telemetry trace."""

    params: torch.nn.Module
    opt: dict
    loop: FaultTolerantLoop
    ckpt: CheckpointManager
    trace: PowerTrace


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="olmo-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs "
                         "the kernels' plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    entry = get_arch(args.arch)
    cfg = entry.smoke() if args.smoke else entry.full()
    shape = ShapeConfig("custom", args.seq, args.batch, "train")
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1), remat="none")

    params = make_params(cfg, tc.seed, dev)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, tc)
    data = make_batch_iterator(cfg, shape)
    ckpt = CheckpointManager(Path(args.ckpt_dir) / cfg.name)
    loop = FaultTolerantLoop(FaultPolicy(checkpoint_every=args.ckpt_every))

    # energy plan for this step shape (paper C5): roofline-coupled clock,
    # built through the unified Workload adapter (repro_torch.cluster) so
    # the driver and the cluster scheduler share one definition
    workload = TrainWorkload(arch=args.arch, steps=args.steps,
                             batch=args.batch, seq=args.seq,
                             smoke=args.smoke)
    plan, ac = workload.energy_plan()
    print(f"[energy] dominant={plan.dominant} freq={plan.freq_scale:.2f} "
          f"power={plan.power_w:.0f}W perf_loss={plan.perf_loss:.3%} "
          f"({workload.chip.name}, modelled)")

    # telemetry: each step emits a chip-power sample into the shared bus
    # (energy comes from integrating the trace, not a private W×s product)
    recorder = TraceRecorder(source="launch.train")
    recorder.emit(0.0, {"chip": plan.power_w}, flops_rate=0.0,
                  freq_scale=plan.freq_scale)
    t_run = 0.0
    last_good = None    # the step of the copy in ``snap``
    snap = None         # last_good's state, or the state before this step
    for step in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(data).items()}
        if last_good is None:
            snap = _snapshot(params, opt, snap)
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, batch)
        loss = float(metrics["loss"])
        wall = time.perf_counter() - t0
        h = loop.observe(step, wall, loss)
        t_run += wall
        recorder.emit(t_run, {"chip": plan.power_w},
                      flops_rate=ac.flops / max(wall, 1e-9) / 1e9,
                      freq_scale=plan.freq_scale)
        if not h.ok and loop.should_rollback(h):
            print(f"[fault] step {step}: {h.reason}; rolling back")
            _write_back(params, opt, snap)
            continue
        if step % args.ckpt_every == 0:
            ckpt.save(step, params)
            snap = _snapshot(params, opt, snap)
            last_good = step
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:8.4f} "
                  f"wall {wall*1e3:7.1f}ms gnorm "
                  f"{float(metrics['grad_norm']):.3f}")
    ckpt.wait()
    trace = recorder.trace()
    print(f"[energy] total {trace.energy_j()/3600:.4f} Wh over "
          f"{args.steps} steps, avg {trace.avg_power():.0f}W "
          f"({loop.straggler_report()})")
    return TrainRun(params, opt, loop, ckpt, trace)


if __name__ == "__main__":
    main()
