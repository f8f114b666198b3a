"""The port's dry run (``repro_torch.launch.dryrun``,
``repro_torch.roofline.{analysis,report}``) and the B4/B5 ``meta``
branch against the JAX package's, on the CPU.

* ``model_flops`` bit for bit; ``analyze`` priced at a table of the
  reference's TPU constants (``TPU_TABLE``) at rel 1e-12.
* Plans and rooflines for every arch x shape x production mesh x
  variant: ``plan_cell`` with the reference's budgets (12 GiB to serve,
  15 GiB to push TP-only, 12 GiB to train) against the plan the
  reference derives from its own ``param_bytes``, ``kv_cache_bytes``,
  ``should_quantize_kv`` and ``auto_train_plan`` (``dryrun.py:64-160``),
  and ``roofline_record`` under ``TPU_TABLE`` against the reference's
  ``cost_for``/``model_flops``/``bw_useful_ratio`` arithmetic
  (``dryrun.py:204-252``).  No tracing.
* Memory: smoke llama3-8b, mamba2-370m and grok-1-314b on a (2, 4)
  Auto-axis mesh of the 8 CPU devices, prefill, decode, train and
  ``replica1``: the reference's ``lower_cell`` gives the same plan, and
  its ``memory_analysis()`` the same argument bytes per device.  Its
  output bytes carry 8 bytes a leaf more (XLA's output is one tuple, and
  its buffer is a table of one 8-byte pointer per leaf).  Its alias is
  what it donates; the port's is what the step updates in place: equal
  for the train step (parameters and AdamW state), while the port's
  decode copies the attention caches and makes the SSM state anew, so
  it aliases none of the cache the reference donates.
* Collectives: sequence-sharded attention's K/V all-gathers and the MoE
  expert plan's gathers and psum, per chip, against
  ``collective_bytes_from_hlo`` of the reference's compiled body: equal
  bytes of each kind; XLA's all-reduce combiner merges the psum with the
  aux loss's pmean over the same model groups, so the port counts one
  all-reduce call more.
* Report: both packages' ``markdown_table`` and ``pick_hillclimb_cells``
  give identical output on the same records (ok, skip, error), each
  reading the other's.
* The traced counts: the op cache changes none of them; the peak on a
  known sequence; a dense model's FLOPs, whole, equal its matmul FLOPs
  counted by hand for prefill, decode and train (with and without
  remat, one and two microbatches) on one coordinate and on a (2, 4)
  mesh; the bytes per chip of the (2, 4) mesh come to the one
  coordinate's plus the parameter gathers; B4/B5 on ``meta`` return
  the plain versions' shapes and count as traced calls; a CUDA tensor
  still goes to the kernel.
* The CLI on the CPU: one full-width cell on the 256-coordinate mesh;
  its record says its collectives are the explicit bodies' only.
"""
import dataclasses
import json
import math
import os
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

import repro.config as JCF  # noqa: E402
import repro.roofline.analysis as JAN  # noqa: E402
import repro.roofline.analytic as JAA  # noqa: E402
import repro.roofline.report as JR  # noqa: E402
from conftest import need_devices  # noqa: E402
from repro import models as JM  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import moe as JMO  # noqa: E402
from repro.models.transformer import kv_cache_bytes as j_kv_bytes  # noqa
from repro.roofline import hw as jhw  # noqa: E402
from repro.runtime import memplan as JMP  # noqa: E402
from repro_torch import config as TCF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as RK  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as SK  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_ref  # noqa
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import moe as TMO  # noqa: E402
from repro_torch.roofline import analysis as TAN  # noqa: E402
from repro_torch.roofline import report as TR  # noqa: E402
from test_torch_analytic import TPU_TABLE  # noqa: E402

REL = 1e-12
# the reference's budgets: 12 GiB of its 16 GiB chip to serve TP-only
# and to train, 15 GiB when pushed
REF_BUDGETS = dict(serve_budget=JSH.SERVE_TP_ONLY_BUDGET,
                   tp_push_budget=15 * 2**30, train_budget=JMP.HBM_BUDGET)
VARIANTS = ["baseline", "tp_push", "serve_fsdp", "serve_ep", "replica1",
            "block_skip"]
MESHES = ["SINGLE_POD_MESH", "MULTI_POD_MESH"]


def close(got, want, rel=REL):
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float),
                               rtol=rel, atol=0.0)


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [(8_030_261_248, 8_030_261_248, 1_048_576,
                                   "train"),
                                  (314_000_000_000, 86_000_000_000, 4096,
                                   "prefill"),
                                  (370_000_000, 370_000_000, 128, "decode")])
def test_model_flops(args):
    assert TAN.model_flops(*args) == JAN.model_flops(*args)


@pytest.mark.parametrize("chips,terms", [
    (256, (4.1e14, 2.2e11, 3.0e9, 0.0)),
    (512, (1.0e12, 9.9e12, 1.0e8, 5.0e9)),
    (1, (0.0, 0.0, 0.0, 0.0))])
def test_analyze(chips, terms):
    mf = 6.0 * 8e9 * 1_048_576
    got = TAN.analyze(*terms, chips, mf, chip=TPU_TABLE)
    want = JAN.analyze(*terms, chips, mf)
    for k in ("compute_s", "memory_s", "collective_s", "useful_ratio",
              "step_time_lower_bound_s", "roofline_fraction"):
        close(getattr(got, k), getattr(want, k))
    assert got.dominant == want.dominant


# ---------------------------------------------------------------------------
# plans and rooflines: every arch x shape x mesh x variant
# ---------------------------------------------------------------------------

_REF = {}


def _ref_params(arch):
    if arch not in _REF:
        cfg = JCF.full_config(arch)
        _REF[arch] = jax.eval_shape(partial(JM.init_params, cfg),
                                    jax.random.PRNGKey(0))
    return _REF[arch]


def ref_plan(cfg, shape, mesh_cfg, variant):
    """The plan half of the reference's ``lower_cell`` (dryrun.py:64-160),
    from its own functions."""
    serve_mode = "serve" if shape.kind != "train" else "train"
    if "serve_fsdp" in variant:
        serve_mode = "train"
    ep_data = "serve_ep" in variant and cfg.moe.enabled
    tp_only = False
    if serve_mode == "serve":
        cache_b = j_kv_bytes(cfg, shape.global_batch, shape.seq_len)
        if JSP.should_quantize_kv(cfg, shape, mesh_cfg.n_devices):
            cache_b //= 2
        budget = JSH.SERVE_TP_ONLY_BUDGET
        if "tp_push" in variant:
            budget = 15 * 2**30
        budget_left = budget - cache_b // mesh_cfg.n_devices
        tp_only = (JSH.param_bytes(_ref_params(cfg.name))
                   // mesh_cfg.model_size <= max(budget_left, 0))
    plan = {"serve_tp_only": tp_only, "moe_ep_data": ep_data}
    tc = None
    if shape.kind == "train":
        tc = JMP.auto_train_plan(cfg, shape, mesh_cfg)
        plan.update(microbatches=tc.microbatches, moment_dtype=tc.moment_dtype,
                    grad_accum_dtype=tc.grad_accum_dtype, remat=tc.remat)
    elif shape.kind == "prefill":
        plan["kv_cache_int8"] = JSP.should_quantize_kv(cfg, shape,
                                                       mesh_cfg.n_devices)
    elif "replica1" in variant:
        plan["kv_cache_int8"] = JSP.should_quantize_kv(cfg, shape, 1)
        plan["replicas"] = mesh_cfg.n_devices
    else:
        plan["kv_cache_int8"] = JSP.should_quantize_kv(cfg, shape,
                                                       mesh_cfg.n_devices)
    return plan, tc


def ref_roofline(cfg, shape, mesh_cfg, variant, plan, tc):
    """The reference's ``run_cell`` arithmetic (dryrun.py:204-252)."""
    n_dev = mesh_cfg.n_devices
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mf = JAN.model_flops(cfg.param_count(), cfg.active_param_count(), tokens,
                         shape.kind)
    replicas = mesh_cfg.n_devices if "replica1" in variant else 1
    ac = JAA.cost_for(cfg, shape, mesh_cfg, tc,
                      block_skip="block_skip" in variant,
                      serve_tp_only=plan.get("serve_tp_only", True),
                      kv_int8=plan.get("kv_cache_int8", False),
                      moe_ep=plan.get("moe_ep_data", False),
                      replicas=replicas)
    bw_useful = None
    if shape.kind == "decode":
        _, cache = JSP.decode_input_specs(
            cfg, shape, quantize_kv_cache=plan.get("kv_cache_int8", False))
        pb = JSH.param_bytes(_ref_params(cfg.name))
        cb = JSH.param_bytes(cache)
        active_frac = cfg.active_param_count() / max(cfg.param_count(), 1)
        useful = (pb * active_frac + cb) / (n_dev // replicas)
        bw_useful = useful / max(ac.hbm_bytes, 1.0)
    terms = {"compute": ac.compute_s, "memory": ac.memory_s,
             "collective": ac.collective_s}
    step_lb = max(terms.values())
    return {
        "compute_s": ac.compute_s, "memory_s": ac.memory_s,
        "collective_s": ac.collective_s,
        "dominant": max(terms, key=terms.get),
        "flops_per_chip": ac.flops, "hbm_bytes_per_chip": ac.hbm_bytes,
        "ici_bytes_per_chip": ac.ici_bytes,
        "dcn_bytes_per_chip": ac.dcn_bytes, "model_flops": mf,
        "useful_ratio": mf / max(ac.flops * n_dev, 1.0),
        "step_lower_bound_s": step_lb,
        "roofline_fraction": ((mf / n_dev / step_lb) / jhw.PEAK_BF16_FLOPS
                              if step_lb > 0 else 0.0),
        "bw_useful_ratio": bw_useful, "detail": ac.detail,
    }


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", list(JCF.SHAPES))
@pytest.mark.parametrize("arch", JCF.ARCH_IDS)
def test_plan_and_roofline(arch, shape, mesh, variant):
    jcfg, tcfg = JCF.full_config(arch), TCF.full_config(arch)
    jshape, tshape = JCF.SHAPES[shape], TCF.SHAPES[shape]
    jmc, tmc = getattr(JCF, mesh), getattr(TCF, mesh)
    plan, tc = TD.plan_cell(tcfg, tshape, tmc, variant, **REF_BUDGETS)
    jplan, jtc = ref_plan(jcfg, jshape, jmc, variant)
    assert plan == jplan
    assert (tc is None) == (jtc is None)
    if tc is not None:
        assert dataclasses.asdict(tc) == dataclasses.asdict(jtc)
    got = TD.roofline_record(tcfg, tshape, tmc, variant, plan, tc,
                             chip=TPU_TABLE)
    want = ref_roofline(jcfg, jshape, jmc, variant, jplan, jtc)
    assert got.keys() == want.keys()
    assert got["dominant"] == want["dominant"]
    assert got["detail"] == want["detail"]
    assert (got["bw_useful_ratio"] is None) == (want["bw_useful_ratio"]
                                                is None)
    for k, v in want.items():
        if k not in ("dominant", "detail") and v is not None:
            close(got[k], v)


def test_default_budgets_are_the_cards():
    """Without the reference's budgets the plan is priced at the H100's
    80 GB: 75% to serve and train, 15/16 to push."""
    assert TD.TP_PUSH_BUDGET == int(15 / 16 * 80e9)
    assert SH.SERVE_TP_ONLY_BUDGET == int(0.75 * 80e9)
    cfg = TCF.full_config("grok-1-314b")
    plan, _ = TD.plan_cell(cfg, TCF.SHAPES["decode_32k"],
                           TCF.SINGLE_POD_MESH)
    ref, _ = TD.plan_cell(cfg, TCF.SHAPES["decode_32k"],
                          TCF.SINGLE_POD_MESH, **REF_BUDGETS)
    assert plan["serve_tp_only"] and not ref["serve_tp_only"]


# ---------------------------------------------------------------------------
# memory per device on a (2, 4) mesh, against XLA's memory_analysis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` put back: the
    module sets a 512-device flag when imported, which would reach any
    later JAX process of this worker."""
    need_devices(8)
    saved = os.environ.get("XLA_FLAGS")
    jax.devices()                         # the backend is up: 8 devices
    import repro.launch.dryrun as mod
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return mod


MEM_CELLS = [(a, k, v) for a in ("llama3-8b", "mamba2-370m", "grok-1-314b")
             for k, v in (("prefill", "baseline"), ("decode", "baseline"),
                          ("train", "baseline"), ("decode", "replica1"))]


@pytest.mark.parametrize("arch,kind,variant", MEM_CELLS)
def test_memory_against_xla(arch, kind, variant, ref_dryrun):
    shape = (2, 4)
    jmesh = jax.make_mesh(shape, ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    jmc = JCF.MeshConfig(shape, ("data", "model"))
    tmc = TCF.MeshConfig(shape, ("data", "model"))
    jshape = JCF.ShapeConfig("t", 64, 8, kind)
    tshape = TCF.ShapeConfig("t", 64, 8, kind)
    compiled, _, _, jplan = ref_dryrun.lower_cell(
        JCF.smoke_config(arch), jshape, jmesh, jmc, variant)
    jplan.pop("tc", None)
    mem = compiled.memory_analysis()
    tcfg = TCF.smoke_config(arch)
    plan, tc = TD.plan_cell(tcfg, tshape, tmc, variant, **REF_BUDGETS)
    assert plan == jplan
    mesh = SH.lm_mesh(shape, ("data", "model"), devices=("meta",))
    cost, got = TD.trace_cell(tcfg, tshape, mesh, tmc, variant, plan, tc)
    assert got["argument_size_in_bytes"] == mem.argument_size_in_bytes
    n_out = compiled.out_tree.num_leaves
    assert (got["output_size_in_bytes"] + 8 * n_out
            == mem.output_size_in_bytes)
    if kind == "decode" and variant == "baseline":
        # the reference donates the cache; the port's decode copies it
        logits = cost.result[0]
        spec = SH.pick(tuple(logits.shape),
                       [SH.P(("data",), "model"), SH.P(None, "model"),
                        SH.P()], tmc)
        cache = (got["output_size_in_bytes"]
                 - TD._block_bytes(logits, spec, mesh))
        assert got["alias_size_in_bytes"] == 0
        assert mem.alias_size_in_bytes == cache
    else:
        assert got["alias_size_in_bytes"] == mem.alias_size_in_bytes
    assert got["temp_size_in_bytes"] > 0
    assert got["total_hbm_bytes"] == (
        got["argument_size_in_bytes"] + got["output_size_in_bytes"]
        + got["temp_size_in_bytes"] - got["alias_size_in_bytes"])


# ---------------------------------------------------------------------------
# collectives against the reference's compiled bodies
# ---------------------------------------------------------------------------

def _smoke(arch):
    jcfg = dataclasses.replace(JCF.smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(TCF.smoke_config(arch), dtype="float32")
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("arch,shape", [("qwen1.5-32b", (2, 2)),
                                        ("qwen1.5-32b", (2, 4)),
                                        ("grok-1-314b", (2, 2)),
                                        ("grok-1-314b", (4, 2))])
def test_collectives_against_hlo(arch, shape):
    need_devices(8)
    jcfg, tcfg, jp, tp = _smoke(arch)
    jmesh = jax.make_mesh(shape, ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    mesh = SH.lm_mesh(shape, ("data", "model"), devices=("cpu",))
    n = shape[0] * shape[1]
    if arch.startswith("qwen"):              # 5 heads: sequence-sharded
        x = np.random.default_rng(1).standard_normal(
            (4, 64, tcfg.d_model)).astype(np.float32)
        jpa = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
        fn = jax.jit(lambda p, x: JA.gqa_forward(
            jcfg, p, x, positions=jnp.arange(64), mesh=jmesh)[0])
        hlo = fn.lower(jpa, jnp.asarray(x)).compile().as_text()
        TA.gqa_forward(tcfg, tp.layers[0].attn, torch.from_numpy(x),
                       positions=torch.arange(64), mesh=mesh)
    else:                                    # the "expert" plan, FSDP
        x = np.random.default_rng(2).standard_normal(
            (8, 16, tcfg.d_model)).astype(np.float32)
        jpm = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
        fn = jax.jit(lambda p, x: JMO.moe_forward(jcfg, p, x, mesh=jmesh,
                                                   fsdp=True))
        hlo = fn.lower(jpm, jnp.asarray(x)).compile().as_text()
        TMO.moe_forward(tcfg, tp.layers[0].moe, torch.from_numpy(x),
                        mesh=mesh, fsdp=True)
    ici, dcn, stats = TAN.collective_stats(mesh)
    jici, jdcn, jstats = JAN.collective_bytes_from_hlo(hlo, n, 0)
    assert (ici, dcn) == (jici, jdcn) and dcn == 0
    assert stats.keys() == jstats.keys()
    for k, st in stats.items():
        j = jstats[k]
        assert (st["out_bytes"], st["wire_bytes"], st["cross_pod"]) == \
            (j["out_bytes"], j["wire_bytes"], j["cross_pod"])
        # XLA merges the psum and the aux loss's pmean over the model axis
        assert st["count"] == j["count"] + (k == "all-reduce")


def test_collective_stats_pod_axis():
    """A collective along ``pod`` is keyed ``/dcn`` and charged to DCN;
    bytes are per chip (the mesh's sums over its size)."""
    from repro_torch.distributed.collectives import all_gather, psum
    mesh = SH.lm_mesh((2, 2, 2), ("pod", "data", "model"), devices=("cpu",))
    xs = {c: torch.ones(4, 8) for c in mesh.coords()}
    all_gather(mesh, xs, "pod", 0)
    psum(mesh, xs, "model")
    ici, dcn, stats = TAN.collective_stats(mesh)
    assert stats["all-gather/dcn"] == {
        "kind": "all-gather/dcn", "count": 1, "out_bytes": 256,
        "wire_bytes": 128.0, "cross_pod": True}
    assert stats["all-reduce"] == {
        "kind": "all-reduce", "count": 1, "out_bytes": 128,
        "wire_bytes": 128.0, "cross_pod": False}
    assert (ici, dcn) == (128.0, 128.0)
    assert mesh.traffic == {"all_gather": 1024, "psum": 1024}


# ---------------------------------------------------------------------------
# traced counts
# ---------------------------------------------------------------------------

def test_traced_peak_and_bytes():
    x = torch.empty(1000, device="meta")

    def fn(x):
        a = x * 2                # 4000 B live
        b = a + 1                # 8000 B: the peak
        del a
        return b.sum()           # 4000 + 4 B

    cost = TAN.traced_cost(fn, x)
    assert cost.peak_bytes == 8000
    assert cost.bytes == 2 * 8000 + 4000 + 4
    assert cost.made_bytes == 4
    assert cost.flops == 0


def test_op_cache_changes_no_count(monkeypatch):
    """Every count of a traced train step over a mesh, with and without
    the cache of repeated operations."""
    cfg = TCF.smoke_config("qwen1.5-32b")
    tmc = TCF.MeshConfig((2, 2), ("data", "model"))
    shape = TCF.ShapeConfig("t", 64, 8, "train")
    plan, tc = TD.plan_cell(cfg, shape, tmc, **REF_BUDGETS)

    def counts():
        mesh = SH.lm_mesh((2, 2), ("data", "model"), devices=("meta",))
        cost, mem = TD.trace_cell(cfg, shape, mesh, tmc, "baseline", plan,
                                  tc)
        return (cost.flops, cost.bytes, cost.peak_bytes, cost.made_bytes,
                cost.kernel_calls, cost.collectives, mem)

    cached = counts()
    scan = TAN._scan

    def no_key(x, tensors):
        scan(x, tensors)
        return TAN._NO_KEY

    monkeypatch.setattr(TAN, "_scan", no_key)
    assert counts() == cached
    assert cached[0] > 0 and cached[5]["all-gather"]["count"] > 0


def _llama_flops(cfg, kind, B, S, remat):
    """The matmul FLOPs of a dense GQA step (what ``FlopCounterMode``
    counts), whole: every projection 2 T (its weights), attention's two
    matmuls 4 B H S Sk dh, the LM head on the last token (serve) or on
    all of them (train).  Training runs every forward matmul twice more
    in backward; the loss chunk's checkpoint runs the LM head once more;
    layer remat runs each layer once more, all but the MLP's down
    projection (the checkpoint stops once it has made again the last
    tensor that backward reads)."""
    d, H, K, dh, F, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head, cfg.d_ff, cfg.vocab_padded,
                            cfg.n_layers)
    w = d * H * dh + 2 * d * K * dh + H * dh * d + 3 * d * F
    if kind == "decode":                  # one token over an S-long cache
        return L * (2 * B * w + 4 * B * H * S * dh) + 2 * B * d * V
    T = B * S
    layer = 2 * T * w + 4 * B * H * S * S * dh
    if kind == "prefill":
        return L * layer + 2 * B * d * V
    head = 2 * T * d * V
    return (3 * (L * layer + head) + head
            + (L * (layer - 2 * T * F * d) if remat != "none" else 0))


@pytest.mark.parametrize("mshape", [(1, 1), (2, 4)])
@pytest.mark.parametrize("kind,remat,M", [
    ("prefill", None, None), ("decode", None, None), ("train", "none", 1),
    ("train", "layer", 1), ("train", "layer", 2)])
def test_traced_flops_count_the_model(kind, remat, M, mshape):
    """The traced FLOPs per chip, times the chips, are the step's matmul
    FLOPs counted by hand: a wrong per-chip divisor, or a backward, remat
    or microbatch pass left out, shows here."""
    cfg = TCF.smoke_config("llama3-8b")
    B, S = 8, 64
    shape = TCF.ShapeConfig("t", S, B, kind)
    tmc = TCF.MeshConfig(mshape, ("data", "model"))
    plan, tc = TD.plan_cell(cfg, shape, tmc, **REF_BUDGETS)
    if tc is not None:
        tc = dataclasses.replace(tc, remat=remat, microbatches=M)
    mesh = SH.lm_mesh(mshape, ("data", "model"), devices=("meta",))
    cost, _ = TD.trace_cell(cfg, shape, mesh, tmc, "baseline", plan, tc)
    assert cost.chips == tmc.n_devices
    close(cost.flops * cost.chips, _llama_flops(cfg, kind, B, S, remat))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_traced_bytes_per_chip(kind):
    """The same serve step on one coordinate and on a (2, 4) mesh: the
    mesh's bytes per chip, times its 8 chips, are the one coordinate's
    plus the parameter gathers (each sharded parameter's blocks read and
    its whole tensor written)."""
    cfg = TCF.smoke_config("llama3-8b")
    shape = TCF.ShapeConfig("t", 64, 8, kind)
    total, gathered = {}, 0
    for mshape in [(1, 1), (2, 4)]:
        tmc = TCF.MeshConfig(mshape, ("data", "model"))
        plan, tc = TD.plan_cell(cfg, shape, tmc, **REF_BUDGETS)
        mesh = SH.lm_mesh(mshape, ("data", "model"), devices=("meta",))
        _, args, _, _ = TD.cell_step(cfg, shape, mesh, tmc, "baseline",
                                     plan, tc)
        gathered = sum(2 * math.prod(st.shape) * st.dtype.itemsize
                       for st in args[0].values() if len(st.blocks()) > 1)
        cost, _ = TD.trace_cell(cfg, shape, mesh, tmc, "baseline", plan, tc)
        total[mshape] = cost.bytes * cost.chips
    assert gathered > 0
    assert total[(2, 4)] == total[(1, 1)] + gathered


def test_meta_branch():
    """B4/B5 on ``meta`` return the plain versions' shapes and dtypes,
    count as traced calls and launch nothing; under autograd they go
    through the kernels' Functions, as on the card."""
    RK.reset_launches()
    SK.reset_launches()
    x = torch.empty(6, 5, 32, dtype=torch.bfloat16, device="meta")
    w = torch.empty(32, dtype=torch.bfloat16, device="meta")
    y = rmsnorm(x, w)
    want = rmsnorm_ref(x, w, 1e-6)
    assert (y.shape, y.dtype, y.device.type) == (want.shape, want.dtype,
                                                 "meta")
    args = [torch.empty(s, dtype=d, device="meta") for s, d in (
        ((2, 16, 3, 8), torch.bfloat16), ((2, 16, 3), torch.float32),
        ((3,), torch.float32), ((2, 16, 4), torch.bfloat16),
        ((2, 16, 4), torch.bfloat16), ((2, 3, 8, 4), torch.float32))]
    out = ssd_chunk(*args)
    ref = ssd_chunk_ref(*args)
    assert [(t.shape, t.dtype) for t in out] == \
        [(t.shape, t.dtype) for t in ref]
    xg = x.float().requires_grad_()
    yg = rmsnorm(xg, w)
    assert yg.grad_fn.name() == "RMSNormFunctionBackward"
    yg.sum().backward()
    assert xg.grad.shape == xg.shape
    assert RK.TRACED == {"rmsnorm": 2} and SK.TRACED == {"ssd_chunk": 1}
    assert RK.LAUNCHES == {"rmsnorm": 0} and SK.LAUNCHES == {"ssd_chunk": 0}
    RK.reset_launches()
    SK.reset_launches()
    assert RK.TRACED == {"rmsnorm": 0} and SK.TRACED == {"ssd_chunk": 0}


def test_cuda_tensors_still_reach_the_kernels(monkeypatch):
    """A CUDA tensor goes to the kernel and raises where the kernel
    cannot run (here: no card, so loading its library fails); tensors on
    ``meta`` and the CPU together raise in the kernel's device check."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def no_card():
        raise RuntimeError("no card")

    monkeypatch.setattr(RK, "_lib", no_card)
    monkeypatch.setattr(SK, "_lib", no_card)
    with FakeTensorMode():
        x = torch.empty(4, 32, dtype=torch.bfloat16, device="cuda")
        w = torch.empty(32, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(RuntimeError, match="no card"):
            rmsnorm(x, w)
        args = [torch.empty(s, dtype=d, device="cuda") for s, d in (
            ((2, 16, 3, 8), torch.bfloat16), ((2, 16, 3), torch.float32),
            ((3,), torch.float32), ((2, 16, 4), torch.bfloat16),
            ((2, 16, 4), torch.bfloat16), ((2, 3, 8, 4), torch.float32))]
        with pytest.raises(RuntimeError, match="no card"):
            ssd_chunk(*args)
    with pytest.raises(ValueError, match="one CUDA device"):
        rmsnorm(torch.empty(4, 32, device="meta"), torch.ones(32))
    assert RK.TRACED == {"rmsnorm": 0}


# ---------------------------------------------------------------------------
# the CLI and the report
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """The CLI's records in one directory (an ok decode cell, a skip),
    an error record as ``run_cell`` writes one, and the ok record with
    the reference's key names in a directory of its own."""
    out = tmp_path_factory.mktemp("dryrun_torch")
    TD.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
             "--out", str(out)])
    TD.main(["--arch", "llama3-8b", "--shape", "long_500k", "--out",
             str(out)])
    err = {"arch": "olmo-1b", "shape": "train_4k", "mesh": "16x16",
           "variant": "baseline", "status": "error",
           "error": "RuntimeError: x", "traceback": "..."}
    TD._write(out / "olmo-1b--train_4k--pod1--baseline.json", err)
    ref_dir = tmp_path_factory.mktemp("dryrun_ref")
    rec = json.loads(
        (out / "mamba2-370m--decode_32k--pod1--baseline.json").read_text())
    rec["lower_s"], rec["compile_s"] = rec.pop("plan_s"), rec.pop("trace_s")
    rec["xla_cost"] = rec.pop("traced")
    (ref_dir / "mamba2-370m--decode_32k--pod1--baseline.json").write_text(
        json.dumps(rec))
    return out, ref_dir


def test_cli_record(records):
    out, _ = records
    rec = json.loads(
        (out / "mamba2-370m--decode_32k--pod1--baseline.json").read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    cfg = TCF.full_config("mamba2-370m")
    plan, tc = TD.plan_cell(cfg, TCF.SHAPES["decode_32k"],
                            TCF.SINGLE_POD_MESH)
    assert rec["plan"] == plan
    want = TD.roofline_record(cfg, TCF.SHAPES["decode_32k"],
                              TCF.SINGLE_POD_MESH, "baseline", plan, tc)
    assert rec["roofline"] == json.loads(json.dumps(want))
    # one RMSNorm before each of the 48 mixers, the final norm, and each
    # mixer's gated norm; decode runs no SSD chunk
    assert rec["traced"]["kernel_calls_per_chip"] == {"rmsnorm": 97,
                                                      "ssd_chunk": 0}
    m = rec["memory"]
    assert m["total_hbm_bytes"] == (
        m["argument_size_in_bytes"] + m["output_size_in_bytes"]
        + m["temp_size_in_bytes"] - m["alias_size_in_bytes"])
    assert rec["fits_hbm"] == (m["total_hbm_bytes"] <= 80e9)
    assert set(rec) >= {"plan_s", "trace_s", "collectives"}
    # the mesh logs only the explicit bodies' collectives, and a
    # mamba2 decode runs none
    assert rec["collectives_scope"] == "explicit_bodies"
    assert rec["collectives"] == {}
    assert rec["traced"]["explicit_ici_bytes_per_chip"] == 0
    skip = json.loads(
        (out / "llama3-8b--long_500k--pod1--baseline.json").read_text())
    assert skip["status"] == "skip"


def test_reports_agree(records):
    out, ref_dir = records
    cells = TR.load_cells(out)
    assert cells == JR.load_cells(out)
    assert [c["status"] for c in cells] == ["skip", "ok", "error"]
    assert TR.markdown_table(cells) == JR.markdown_table(cells)
    assert TR.pick_hillclimb_cells(cells) == JR.pick_hillclimb_cells(cells)
    ref_cells = JR.load_cells(ref_dir)
    assert TR.markdown_table(ref_cells) == JR.markdown_table(ref_cells)
    # the same cell under either package's key names renders one row
    assert TR.markdown_table(ref_cells).splitlines()[-1] in \
        TR.markdown_table(cells)
    # the reference's quirk, kept: no ok decode cell raises
    no_decode = [dict(c, shape="train_4k") for c in cells]
    for mod in (TR, JR):
        with pytest.raises(ValueError):
            mod.pick_hillclimb_cells(no_decode)
    assert TR.fmt_s(None) == JR.fmt_s(None) == "-"
    for x in (2.5, 0.0123, 4.2e-5):
        assert TR.fmt_s(x) == JR.fmt_s(x)
