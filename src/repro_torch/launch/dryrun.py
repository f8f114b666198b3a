"""Multi-pod dry run: plan and trace every (architecture × input shape)
against the production mesh on ``meta`` tensors, and record the plan, the
roofline, the memory per chip and the collectives: the counterpart of the
JAX package's ``launch/dryrun.py``.

The reference lowers and compiles each cell with XLA against 256 or 512
placeholder CPU devices and reads the compiled artifact.  The port has no
XLA: its mesh is an ``LMMesh`` whose coordinates all sit on the ``meta``
device, so nothing is allocated anywhere, and ``roofline.traced_cost``
runs the step itself and counts what it does.  It sets no environment
variable and needs no card.  The record keeps the reference's keys
wherever their meaning carries over, so either package's
``roofline/report.py`` renders either package's records; ``lower_s`` and
``compile_s`` become ``plan_s`` and ``trace_s``, and ``xla_cost`` becomes
``traced``.  The roofline's terms are the analytic ``cost_for`` at the
H100 SXM's rates, and ``fits_hbm`` holds the memory against its 80 GB.

``collectives`` and ``traced``'s ``explicit_ici_bytes_per_chip`` /
``explicit_dcn_bytes_per_chip`` count only the collectives of the
explicit per-shard bodies (sequence-sharded attention, the MoE plans),
which the mesh logs as they run; the record says so under
``collectives_scope``.  The gathers and reductions XLA's partitioner
would place (FSDP parameter gathers, the gradient reduction,
tensor-parallel all-reduces) are not run as collectives here: the step
gathers each parameter whole on the controller.  The roofline's
``ici_bytes_per_chip``/``dcn_bytes_per_chip`` price them analytically.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--resume]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config import (ARCH_IDS, SHAPES, MeshConfig, ModelConfig,
                                ShapeConfig, TrainConfig, full_config,
                                shape_applicable)
from repro_torch.distributed.sharding import (SERVE_TP_ONLY_BUDGET, P,
                                              ShardedTensor, Sharding,
                                              batch_pspecs, cache_pspecs,
                                              named_shardings, param_bytes,
                                              param_pspecs, pick, shard_tree)
from repro_torch.launch.mesh import make_production_mesh, mesh_config
from repro_torch.launch.specs import (decode_input_specs, input_specs,
                                      should_quantize_kv)
from repro_torch.models.transformer import (empty_params, init_decode_cache,
                                           init_params, kv_cache_bytes)
from repro_torch.optim import adamw_init
from repro_torch.power.model import H100_SXM, ChipTable
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import (TracedCost, model_flops,
                                           traced_cost)
from repro_torch.roofline.analytic import cost_for
from repro_torch.runtime.memplan import HBM_BUDGET, auto_train_plan
from repro_torch.runtime.steps import (make_decode_step, make_prefill_step,
                                       make_train_step)

DEFAULT_OUT = (Path(__file__).resolve().parents[3] / "experiments"
               / "dryrun_torch")
# serving TP-only pushed closer to the card's memory: 15/16 of it, as the
# reference pushes to 15 of its chip's 16 GiB
TP_PUSH_BUDGET = int(15 / 16 * hw.HBM_PER_CHIP)
# what the record's ``collectives`` cover (see the module's docstring)
COLLECTIVES_SCOPE = "explicit_bodies"


def _cell_name(arch: str, shape: str, multi_pod: bool, variant: str) -> str:
    mesh = "pod2" if multi_pod else "pod1"
    return f"{arch}--{shape}--{mesh}--{variant}"


def plan_cell(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
              variant: str = "baseline", *,
              serve_budget: int = SERVE_TP_ONLY_BUDGET,
              tp_push_budget: int = TP_PUSH_BUDGET,
              train_budget: int = HBM_BUDGET,
              ) -> Tuple[Dict[str, Any], Optional[TrainConfig]]:
    """The plan half of the reference's ``lower_cell``: (plan_info, the
    train step's ``TrainConfig`` or None).  Serving is TP-only when the
    TP-sharded weights fit the budget left beside each chip's share of the
    KV cache (``tp_push`` pushes the budget); ``serve_fsdp`` forces the
    FSDP specs; ``serve_ep`` puts a MoE's experts over the data axes;
    ``replica1`` serves one unsharded replica per chip; training takes
    ``auto_train_plan``'s plan under ``train_budget``."""
    serve_mode = "serve" if shape.kind != "train" else "train"
    if "serve_fsdp" in variant:
        serve_mode = "train"          # force FSDP specs even for serving
    ep_data = "serve_ep" in variant and cfg.moe.enabled
    tp_only = False
    if serve_mode == "serve":
        cache_b = kv_cache_bytes(cfg, shape.global_batch, shape.seq_len)
        if should_quantize_kv(cfg, shape, mesh_cfg.n_devices):
            cache_b //= 2
        budget = tp_push_budget if "tp_push" in variant else serve_budget
        budget_left = budget - cache_b // mesh_cfg.n_devices
        tp_only = (param_bytes(empty_params(cfg, "meta"))
                   // mesh_cfg.model_size <= max(budget_left, 0))
    plan: Dict[str, Any] = {"serve_tp_only": tp_only, "moe_ep_data": ep_data}
    tc = None
    if shape.kind == "train":
        tc = auto_train_plan(cfg, shape, mesh_cfg, budget=train_budget)
        plan.update(microbatches=tc.microbatches,
                    moment_dtype=tc.moment_dtype,
                    grad_accum_dtype=tc.grad_accum_dtype, remat=tc.remat)
    elif shape.kind == "prefill":
        plan["kv_cache_int8"] = should_quantize_kv(cfg, shape,
                                                   mesh_cfg.n_devices)
    elif "replica1" in variant:       # replica-parallel: 1 chip/stream
        plan["kv_cache_int8"] = should_quantize_kv(cfg, shape, 1)
        plan["replicas"] = mesh_cfg.n_devices
    else:
        plan["kv_cache_int8"] = should_quantize_kv(cfg, shape,
                                                   mesh_cfg.n_devices)
    return plan, tc


def roofline_record(cfg: ModelConfig, shape: ShapeConfig,
                    mesh_cfg: MeshConfig, variant: str, plan: Dict,
                    tc: Optional[TrainConfig], *,
                    chip: ChipTable = H100_SXM) -> Dict[str, Any]:
    """The record's ``roofline``: the analytic ``cost_for`` at ``chip``'s
    rates, ``model_flops``, the useful ratio, the roofline fraction and,
    for decode, the share of the bytes that are one read of the active
    weights and the cache (the reference's ``run_cell`` arithmetic)."""
    n_dev = mesh_cfg.n_devices
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = model_flops(cfg.param_count(), cfg.active_param_count(), tokens,
                     shape.kind)
    replicas = n_dev if "replica1" in variant else 1
    ac = cost_for(cfg, shape, mesh_cfg, tc,
                  block_skip="block_skip" in variant,
                  serve_tp_only=plan.get("serve_tp_only", True),
                  kv_int8=plan.get("kv_cache_int8", False),
                  moe_ep=plan.get("moe_ep_data", False),
                  replicas=replicas, chip=chip)
    # decode is bandwidth-bound: useful bytes = one read of the (active)
    # weights + one read of the KV/state cache per step, per chip
    bw_useful = None
    if shape.kind == "decode":
        _, cache = decode_input_specs(
            cfg, shape, quantize_kv_cache=plan.get("kv_cache_int8", False))
        pb = param_bytes(empty_params(cfg, "meta"))
        cb = sum(t.numel() * t.element_size() for t, _ in _leaves(cache))
        active_frac = cfg.active_param_count() / max(cfg.param_count(), 1)
        chips_per_replica = n_dev // replicas
        useful = (pb * active_frac + cb) / chips_per_replica
        bw_useful = useful / max(ac.hbm_bytes, 1.0)
    terms = {"compute": ac.compute_s, "memory": ac.memory_s,
             "collective": ac.collective_s}
    dominant = max(terms, key=terms.get)
    step_lb = max(terms.values())
    useful_frac = ((mf / n_dev / step_lb) / chip.peak_bf16_flops
                   if step_lb > 0 else 0.0)
    return {
        "compute_s": ac.compute_s,
        "memory_s": ac.memory_s,
        "collective_s": ac.collective_s,
        "dominant": dominant,
        "flops_per_chip": ac.flops,
        "hbm_bytes_per_chip": ac.hbm_bytes,
        "ici_bytes_per_chip": ac.ici_bytes,
        "dcn_bytes_per_chip": ac.dcn_bytes,
        "model_flops": mf,
        "useful_ratio": mf / max(ac.flops * n_dev, 1.0),
        "step_lower_bound_s": step_lb,
        "roofline_fraction": useful_frac,
        "bw_useful_ratio": bw_useful,
        "detail": ac.detail,
    }


# ---------------------------------------------------------------------------
# Tracing one cell
# ---------------------------------------------------------------------------

def _block_bytes(t, spec: Optional[P], mesh) -> int:
    """Bytes of one coordinate's block of ``t`` (a tensor or a
    ``ShardedTensor``) under ``spec`` (None: whole).  The sharding rules
    pick only specs that split evenly, so every block is the same size."""
    if isinstance(t, ShardedTensor):
        t = t.shards[mesh.coords()[0]]
        return t.numel() * t.element_size()
    n = t.numel() * t.element_size()
    if spec is None:
        return n
    for _, count in Sharding(mesh, spec).block(mesh.coords()[0], t.dim()):
        n //= count
    return n


def _leaves(tree, specs=None):
    """(leaf, its spec) pairs of a dict tree (a model: its parameters),
    specs None where not given."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, specs.get(k) if isinstance(specs, dict)
                               else specs)
    else:
        yield tree, specs


def _ids(leaves) -> set:
    """Each leaf's identity, and each tensor leaf's storage's."""
    out = set()
    for t in leaves:
        out.add(id(t))
        if isinstance(t, torch.Tensor):
            out.add(("storage", t.untyped_storage()._cdata))
    return out


def _filled(t: torch.Tensor, cfg: ModelConfig, device,
            gen: torch.Generator) -> torch.Tensor:
    """A tensor like the stand-in ``t`` on ``device``: token ids below the
    vocabulary, or small normals."""
    if t.dtype.is_floating_point:
        return (0.02 * torch.randn(t.shape, generator=gen, device=device)
                ).to(t.dtype)
    return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                         dtype=t.dtype, device=device)


def cell_step(cfg: ModelConfig, shape: ShapeConfig, mesh,
              mesh_cfg: MeshConfig, variant: str, plan: Dict,
              tc: Optional[TrainConfig], *, device="meta"):
    """The step the plan names over ``mesh``, and its arguments:
    (step, args, the arguments' specs, whether the step is one unsharded
    replica).  On ``meta`` the arguments are stand-ins; on another device
    (the mesh's) the parameters are ``init_params``' from seed 0, the
    batch random tokens and the cache zeros, so the same step runs there
    from the same shapes."""
    if torch.device(device).type == "meta":
        model = empty_params(cfg, "meta")

        def fill(tree):
            return tree
    else:
        gen = torch.Generator(device).manual_seed(0)
        model = init_params(cfg, gen, device)

        def fill(tree):
            return {k: _filled(v, cfg, device, gen) for k, v in tree.items()}
    block_skip = "block_skip" in variant
    serve_mode = "serve" if shape.kind != "train" else "train"
    if "serve_fsdp" in variant:
        serve_mode = "train"
    tp_only, ep_data = plan["serve_tp_only"], plan["moe_ep_data"]
    moe_fsdp = not (tp_only or ep_data)
    pspecs = param_pspecs(cfg, model, mesh_cfg, mode=serve_mode,
                          serve_tp_only=tp_only, moe_ep_data=ep_data)
    whole = "replica1" in variant and shape.kind == "decode"
    if not whole:
        params = shard_tree(model, named_shardings(mesh, pspecs))
    if shape.kind == "train":
        opt = adamw_init(model, getattr(torch, tc.moment_dtype))
        opt = shard_tree(opt, named_shardings(
            mesh, {"m": pspecs, "v": pspecs, "step": P()}))
        batch = fill(input_specs(cfg, shape))
        return (make_train_step(cfg, tc, mesh=mesh, mesh_cfg=mesh_cfg,
                                block_skip=block_skip),
                (params, opt, batch),
                (None, None, batch_pspecs(cfg, batch, mesh_cfg)), False)
    if shape.kind == "prefill":
        batch = fill(input_specs(cfg, shape))
        return (make_prefill_step(
                    cfg, mesh=mesh, mesh_cfg=mesh_cfg, block_skip=block_skip,
                    moe_fsdp=moe_fsdp,
                    quantize_kv_cache=plan["kv_cache_int8"]),
                (params, batch),
                (None, batch_pspecs(cfg, batch, mesh_cfg)), False)
    tokens, cache = decode_input_specs(
        cfg, shape, quantize_kv_cache=plan["kv_cache_int8"])
    tokens = fill({"tokens": tokens})["tokens"]
    if torch.device(device).type != "meta":
        cache = init_decode_cache(cfg, shape.global_batch, shape.seq_len,
                                  quantize_kv_cache=plan["kv_cache_int8"],
                                  device=device)
    if whole:                           # replica-parallel: 1 chip/stream
        return make_decode_step(cfg), (model, tokens, cache), (None,) * 3, \
            True
    return (make_decode_step(cfg, mesh=mesh, mesh_cfg=mesh_cfg,
                             moe_fsdp=moe_fsdp, moe_ep_data=ep_data),
            (params, tokens, cache),
            (None, batch_pspecs(cfg, {"tokens": tokens}, mesh_cfg)["tokens"],
             cache_pspecs(cfg, cache, mesh_cfg)), False)


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               mesh_cfg: MeshConfig, variant: str, plan: Dict,
               tc: Optional[TrainConfig]) -> Tuple[TracedCost, Dict]:
    """The lowering half of the reference's ``lower_cell``: the step the
    plan names (``cell_step``), traced on ``meta`` over ``mesh`` (an
    ``LMMesh`` on ``meta``).  Returns (the traced cost, the memory
    record).

    The memory record is per chip: arguments and outputs are one
    coordinate's blocks under their specs (the parameters', the batch's,
    the cache's, the logits' pick; a ``replica1`` replica's whole
    tensors); ``alias`` the outputs that are arguments updated in place
    (the train step's parameters and AdamW state; decode copies the
    attention caches, so only the cross-attention K/V it passes through
    alias); ``temp`` the traced peak of the bytes the step held, less the
    outputs it made, per chip.  ``total_hbm_bytes`` is the reference's
    sum, so it comes to the arguments plus that peak."""
    step, args, specs, whole = cell_step(cfg, shape, mesh, mesh_cfg,
                                         variant, plan, tc)
    cost = traced_cost(step, *args, mesh=None if whole else mesh)
    out = cost.result
    if shape.kind == "train":
        out_specs = (None, None, None)
    elif whole:
        out_specs = (None, None)
    else:
        out_specs = (pick((shape.global_batch, cfg.vocab_padded),
                          [P(mesh_cfg.data_axes, "model"), P(None, "model"),
                           P()], mesh_cfg),
                     cache_pspecs(cfg, out[1], mesh_cfg))

    def nbytes(t, spec):
        return (t.numel() * t.element_size() if whole
                else _block_bytes(t, spec, mesh))

    arg_leaves = [t for a, s in zip(args, specs) for t, _ in _leaves(a, s)]
    argument = sum(nbytes(t, s) for a, sp in zip(args, specs)
                   for t, s in _leaves(a, sp))
    held = _ids(arg_leaves)
    output = alias = 0
    for o, sp in zip(out, out_specs):
        for t, s in _leaves(o, sp):
            n = nbytes(t, s)
            output += n
            if _ids([t]) & held:
                alias += n
    made = cost.made_bytes / cost.chips
    mem = {
        "argument_size_in_bytes": argument,
        "output_size_in_bytes": output,
        "temp_size_in_bytes": int(max(cost.peak_bytes - made, 0)),
        "alias_size_in_bytes": alias,
        "generated_code_size_in_bytes": 0,
    }
    mem["total_hbm_bytes"] = (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
    return cost, mem


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path, variant: str = "baseline",
             resume: bool = False) -> dict:
    name = _cell_name(arch, shape_name, multi_pod, variant)
    out_path = out_dir / f"{name}.json"
    if resume and out_path.exists():
        rec = json.loads(out_path.read_text())
        print(f"[dryrun] {name}: cached ({rec.get('status')})")
        return rec

    cfg = full_config(arch)
    shape = SHAPES[shape_name]
    rec: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "variant": variant, "status": "pending",
    }
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec.update(status="skip", reason=reason)
        _write(out_path, rec)
        print(f"[dryrun] {name}: SKIP ({reason})")
        return rec

    try:
        mesh_cfg = mesh_config(multi_pod=multi_pod)
        mesh = make_production_mesh(multi_pod=multi_pod, devices=("meta",))
        t0 = time.perf_counter()
        plan, tc = plan_cell(cfg, shape, mesh_cfg, variant)
        t1 = time.perf_counter()
        cost, mem_rec = trace_cell(cfg, shape, mesh, mesh_cfg, variant,
                                   plan, tc)
        t2 = time.perf_counter()
        roof = roofline_record(cfg, shape, mesh_cfg, variant, plan, tc)
        rec.update(
            status="ok",
            plan_s=round(t1 - t0, 2), trace_s=round(t2 - t1, 2),
            n_devices=mesh_cfg.n_devices,
            plan=plan,
            memory=mem_rec,
            fits_hbm=bool(mem_rec["total_hbm_bytes"] <= hw.HBM_PER_CHIP),
            roofline=roof,
            traced={
                "flops_per_chip": cost.flops,
                "bytes_per_chip": cost.bytes,
                "peak_bytes_per_chip": cost.peak_bytes,
                "explicit_ici_bytes_per_chip": cost.ici_bytes,
                "explicit_dcn_bytes_per_chip": cost.dcn_bytes,
                "kernel_calls_per_chip": cost.kernel_calls,
            },
            collectives=cost.collectives,
            collectives_scope=COLLECTIVES_SCOPE,
        )
        print(f"[dryrun] {name}: OK trace={t2 - t1:.0f}s "
              f"dominant={roof['dominant']} "
              f"hbm={mem_rec['total_hbm_bytes'] / 2**30:.2f}GiB "
              f"frac={roof['roofline_fraction']:.3f}")
    except Exception as e:  # noqa: BLE001 — sweep must survive cell failures
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] {name}: ERROR {type(e).__name__}: {e}")
    _write(out_path, rec)
    return rec


def _write(path: Path, rec: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1, default=float))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) for the chosen mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    cells = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        for mp in meshes:
            for a in ARCH_IDS:
                for s in SHAPES:
                    cells.append((a, s, mp))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        for mp in meshes:
            cells.append((args.arch, args.shape, mp))

    n_ok = n_skip = n_err = 0
    for a, s, mp in cells:
        rec = run_cell(a, s, mp, args.out, args.variant, args.resume)
        st = rec["status"]
        n_ok += st == "ok"
        n_skip += st == "skip"
        n_err += st == "error"
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skip, {n_err} error "
          f"of {len(cells)}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
