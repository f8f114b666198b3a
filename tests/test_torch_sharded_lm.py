"""The port's sharded LM path on the CPU against the JAX package's, on the
same mesh shapes.

The reference runs on meshes of the 8 virtual CPU devices built with
``axis_types=(AxisType.Auto,) * n`` (on jax 0.9's default Explicit axes
its ``_constrain`` and its microbatch scan raise); the port runs on ``LMMesh``\\ es of the
same shape whose coordinates all sit on the CPU.  Each function is held
to the reference's **sharded** output: MoE capacity is counted per
shard, so its token drops differ from ``mesh=None``'s, and both packages
drop the same ones.

* sequence-sharded ``gqa_forward`` (qwen smoke, 5 heads, on (2, 2) and
  (2, 4); hymba smoke, 4 heads and a 32-token window, on (1, 8), where
  the window meets the shard offsets);
* ``moe_forward`` (grok smoke, 4 experts, F = 128): the "expert" plan on
  (2, 2) and (4, 2), the "ffn" plan on (1, 8), with and without the FSDP
  gather, and serve-EP (``ep_data``) on (2, 2); deepseek smoke's
  serve-EP;
* ``forward_prefill``, ``forward_decode`` with ``moe_ep_data``,
  ``forward_train_loss`` and one ``make_train_step`` (remat "block", 2
  microbatches) on (2, 2).

Weights are the reference's ``init_params`` carried over by
``convert.params_from_numpy``, inputs numpy draws.  Tolerances, as rtol
and as atol times the reference's largest |value|: float32 1e-5 (the
functions here reach 3e-7 of it, the train step's moments 1.3e-6),
bfloat16 3e-2 (``test_system.py:103``); the train step's parameters
elementwise at rtol = atol = 1e-4 (they reach 2.1e-6).
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from conftest import need_devices  # noqa: E402
from repro import models as JM  # noqa: E402
from repro.config import MeshConfig as JMeshConfig  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import smoke_config as jax_smoke_config  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import moe as JMO  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.runtime import steps as JS  # noqa: E402
from repro_torch import config as TCF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import moe as TMO  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
B, S = 4, 64


@pytest.fixture(autouse=True, scope="module")
def _setup():
    need_devices(8)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jmesh(shape, names=("data", "model")):
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))


def tmesh(shape, names=("data", "model")):
    return SH.lm_mesh(shape, names, devices=("cpu",))


def f32_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


_MODELS = {}


def model(arch, dtype="float32"):
    """(jax cfg, port cfg, jax params, port model), made once."""
    if (arch, dtype) not in _MODELS:
        jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
        tcfg = dataclasses.replace(TCF.smoke_config(arch), dtype=dtype)
        jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                       jax.random.PRNGKey(0))
        _MODELS[(arch, dtype)] = (jcfg, tcfg, jp, convert.params_from_numpy(
            f32_tree(jp), tcfg, "cpu"))
    return _MODELS[(arch, dtype)]


def draw(shape, dtype="float32", seed=1):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def tokens(cfg, batch=B, seq=S, seed=1):
    t = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    return jnp.asarray(t), torch.from_numpy(t)


def close(port, ref, dtype="float32"):
    """``port`` within TOL[dtype] of ``ref`` (rtol, and atol times the
    largest |ref|)."""
    ref = torch.from_numpy(np.array(ref, np.float32))
    tol = TOL[dtype]
    torch.testing.assert_close(port.float(), ref, rtol=tol,
                               atol=tol * max(float(ref.abs().max()), 1e-30))


# ---------------------------------------------------------------------------
# sequence-sharded attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("qwen1.5-32b", (2, 2)),
                                        ("qwen1.5-32b", (2, 4)),
                                        ("hymba-1.5b", (1, 8))])
def test_seq_sharded_gqa_forward(arch, shape):
    jcfg, tcfg, jp, tp = model(arch)
    jx, tx = draw((B, S, tcfg.d_model))
    jpa = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    pos = jnp.arange(S)
    mesh = tmesh(shape)
    ref = jax.jit(lambda p, x: JA.gqa_forward(
        jcfg, p, x, positions=pos, mesh=jmesh(shape))[0])(jpa, jx)
    out, _ = TA.gqa_forward(tcfg, tp.layers[0].attn, tx,
                            positions=torch.arange(S), mesh=mesh)
    assert tcfg.n_heads % shape[1]            # the heads do not divide
    assert mesh.traffic["all_gather"] > 0     # K/V gathered: the path ran
    close(out, ref)
    plain, _ = TA.gqa_forward(tcfg, tp.layers[0].attn, tx,
                              positions=torch.arange(S))
    close(out, np.asarray(plain))             # sharding changes no number


def test_seq_sharding_needs_causal_equal_lengths():
    """Non-causal attention, or a query length the model axis does not
    divide, runs whole: no collective."""
    _, tcfg, _, tp = model("qwen1.5-32b")
    mesh = tmesh((2, 2))
    _, tx = draw((B, 6, tcfg.d_model))
    TA.gqa_forward(tcfg, tp.layers[0].attn, tx, positions=torch.arange(6),
                   causal=False, mesh=mesh)
    _, tx = draw((B, 7, tcfg.d_model))
    TA.gqa_forward(tcfg, tp.layers[0].attn, tx, positions=torch.arange(7),
                   mesh=mesh)
    assert mesh.traffic == {}


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = [("grok-1-314b", (2, 2), True, False),
             ("grok-1-314b", (4, 2), True, False),
             ("grok-1-314b", (1, 8), True, False),
             ("grok-1-314b", (2, 2), False, False),
             ("grok-1-314b", (2, 2), True, True),
             ("deepseek-v2-236b", (2, 2), True, True)]


@pytest.mark.parametrize("arch,shape,fsdp,ep_data", MOE_CASES,
                         ids=lambda v: str(v))
def test_moe_forward(arch, shape, fsdp, ep_data):
    jcfg, tcfg, jp, tp = model(arch)
    jx, tx = draw((8, 16, tcfg.d_model), seed=2)
    jpm = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    plan = TMO.moe_sharding_plan(tcfg, shape[1])
    assert plan == JMO.moe_sharding_plan(jcfg, shape[1])
    ref, raux = jax.jit(lambda p, x: JMO.moe_forward(
        jcfg, p, x, mesh=jmesh(shape), fsdp=fsdp, ep_data=ep_data))(jpm, jx)
    mesh = tmesh(shape)
    out, aux = TMO.moe_forward(tcfg, tp.layers[0].moe, tx, mesh=mesh,
                               fsdp=fsdp, ep_data=ep_data)
    close(out, ref)
    close(aux, raux)
    assert mesh.traffic.get("psum", 0) > 0 or shape[1] == 1


def test_moe_plans():
    """grok smoke's 4 experts split over a model axis of 2 or 4, not 8
    (then its F = 128 does, 16 a coordinate)."""
    cfg = TCF.smoke_config("grok-1-314b")
    assert [TMO.moe_sharding_plan(cfg, m) for m in (1, 2, 4, 8, 3)] == \
        ["expert", "expert", "expert", "ffn", "ffn"]


def test_moe_capacity_is_per_shard():
    """With the smoke capacity, the sharded MoE drops other pairs than
    the one-device MoE: the outputs differ from mesh=None's, as the
    reference's do, and equal the reference's sharded ones (above)."""
    jcfg, tcfg, jp, tp = model("grok-1-314b")
    jx, tx = draw((8, 16, tcfg.d_model), seed=2)
    jpm = jax.tree.map(lambda a: a[0], jp["layers"]["moe"])
    sharded, _ = TMO.moe_forward(tcfg, tp.layers[0].moe, tx,
                                 mesh=tmesh((4, 2)))
    whole, _ = TMO.moe_forward(tcfg, tp.layers[0].moe, tx)
    ref_whole, _ = jax.jit(lambda p, x: JMO.moe_forward(jcfg, p, x))(jpm, jx)
    close(whole, ref_whole)
    assert float((sharded - whole).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# the model over a mesh
# ---------------------------------------------------------------------------

MESH = (2, 2)


@pytest.mark.parametrize("arch,dtype", [("qwen1.5-32b", "float32"),
                                        ("grok-1-314b", "float32"),
                                        ("deepseek-v2-236b", "float32"),
                                        ("grok-1-314b", "bfloat16")])
def test_forward_prefill_and_decode(arch, dtype):
    """Prefill, then two decode steps with serve-EP for the MoE models."""
    jcfg, tcfg, jp, tp = model(arch, dtype)
    jt, tt = tokens(tcfg)
    jm, mesh = jmesh(MESH), tmesh(MESH)
    ep = tcfg.family == "moe"
    jl, jc = jax.jit(lambda p, b: JT.forward_prefill(
        jcfg, p, b, mesh=jm))(jp, {"tokens": jt})
    tl, tc = TT.forward_prefill(tcfg, tp, {"tokens": tt}, mesh=mesh)
    close(tl, jl, dtype)
    jdec = jax.jit(lambda p, t, c: JT.forward_decode(
        jcfg, p, t, c, mesh=jm, moe_ep_data=ep))
    jc = JS.grow_decode_cache(jcfg, jc, B, S + 2)
    tc = steps.grow_decode_cache(tcfg, tc, B, S + 2)
    jtok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)
    for _ in range(2):
        jl, jc = jdec(jp, jtok, jc)
        tl, tc = TT.forward_decode(tcfg, tp, torch.from_numpy(
            np.array(jtok)), tc, mesh=mesh, moe_ep_data=ep)
        close(tl, jl, dtype)
        jtok = jnp.argmax(jl, -1)[:, None].astype(jnp.int32)


@pytest.mark.parametrize("arch", ["qwen1.5-32b", "grok-1-314b"])
def test_forward_train_loss(arch):
    jcfg, tcfg, jp, tp = model(arch)
    jt, tt = tokens(tcfg)
    jl, jlab = tokens(tcfg, seed=3)
    jm = jmesh(MESH)
    ref, rm = jax.jit(lambda p, b: JT.forward_train_loss(
        jcfg, p, b, mesh=jm))(jp, {"tokens": jt, "labels": jl})
    out, m = TT.forward_train_loss(tcfg, tp, {"tokens": tt, "labels": jlab},
                                   mesh=tmesh(MESH))
    close(out.detach(), ref)
    close(m["aux_loss"].detach(), rm["aux_loss"])


def test_constrain_checks_the_spec():
    mesh = tmesh(MESH)
    x = torch.zeros(3, 4)
    assert TT._constrain(x, mesh, SH.P("data", None)) is x   # uneven: fine
    assert TT._constrain(x, None, SH.P("nope")) is x
    with pytest.raises(ValueError):
        TT._constrain(x, mesh, SH.P("pod", None))
    with pytest.raises(ValueError):
        TT._constrain(x, mesh, SH.P("data", None, None))


def test_make_train_step_on_a_mesh():
    """grok smoke, remat "block", 2 microbatches, two steps: the port's
    sharded step (parameters, AdamW state and batch placed by
    ``shard_tree``) against the reference's sharded step: metrics, and
    the parameters and moments gathered back."""
    jcfg, tcfg, jp, tp = model("grok-1-314b")
    jt, tt = tokens(tcfg)
    jl, tl = tokens(tcfg, seed=3)
    kw = dict(remat="block", microbatches=2, warmup_steps=1,
              learning_rate=1e-3)
    jmc = JMeshConfig(MESH, ("data", "model"))
    jm = jmesh(MESH)
    pspecs = JSH.param_pspecs(jcfg, jp, jmc)
    pshard = JSH.named_shardings(jm, pspecs)
    oshard = JSH.named_shardings(jm, {"m": pspecs, "v": pspecs,
                                      "step": JP()})
    jb = {"tokens": jt, "labels": jl}
    bshard = JSH.named_shardings(jm, JSH.batch_pspecs(jcfg, jb, jmc))
    jstep = jax.jit(JS.make_train_step(jcfg, JTrainConfig(**kw), mesh=jm,
                                       mesh_cfg=jmc),
                    in_shardings=(pshard, oshard, bshard),
                    out_shardings=(pshard, oshard, None))
    jpp = jax.device_put(jp, pshard)
    jo = jax.device_put(j_adamw_init(jp), oshard)
    jb = jax.device_put(jb, bshard)

    mesh = tmesh(MESH)
    mc = mesh.config
    tp = copy.deepcopy(tp)
    sh = SH.named_shardings(mesh, SH.param_pspecs(tcfg, tp, mc))
    params = SH.shard_tree(tp, sh)
    opt = SH.shard_tree(adamw_init(tp), {"m": sh, "v": sh,
                                         "step": SH.Sharding(mesh, SH.P())})
    tb = {"tokens": tt, "labels": tl}
    tb = SH.shard_tree(tb, SH.named_shardings(
        mesh, SH.batch_pspecs(tcfg, tb, mc)))
    step = steps.make_train_step(tcfg, TCF.TrainConfig(**kw), mesh=mesh,
                                 mesh_cfg=mc)
    for _ in range(2):
        jpp, jo, jmet = jstep(jpp, jo, jb)
        params, opt, tmet = step(params, opt, tb)
        for k in ("loss", "lm_loss", "aux_loss", "grad_norm", "lr"):
            close(tmet[k], jmet[k])
    got = SH.unshard_tree(params)
    tp_now = convert.params_from_numpy(f32_tree(jpp), tcfg, "cpu")
    for k, p in tp_now.named_parameters():
        # Adam moves a weight by up to lr whatever |g|: elementwise at
        # rtol = atol = 1e-4 (lr / 10), as tests/test_torch_train.py holds
        torch.testing.assert_close(got[k], p.detach(), rtol=1e-4, atol=1e-4)
    m_ref = {k: p.detach() for k, p in convert.params_from_numpy(
        f32_tree(jo["m"]), tcfg, "cpu").named_parameters()}
    m_got = SH.unshard_tree(opt["m"])
    for k, m in m_ref.items():
        scale = max(float(m.abs().max()), 1e-30)
        assert float((m_got[k] - m).abs().max()) <= TOL["float32"] * scale, k
    assert int(SH.unshard_tensor(opt["step"])) == 2


def test_prefill_and_decode_steps_take_sharded_parameters():
    """``make_prefill_step``/``make_decode_step`` over a mesh on serve
    specs (``serve_tp_only`` both ways) give the model's own numbers."""
    _, tcfg, _, tp = model("grok-1-314b")
    _, tt = tokens(tcfg)
    mesh = tmesh(MESH)
    want, wc = steps.make_prefill_step(tcfg, mesh=mesh, mesh_cfg=mesh.config)(
        tp, {"tokens": tt})
    for tp_only in (True, False):
        sh = SH.named_shardings(mesh, SH.param_pspecs(
            tcfg, tp, mesh.config, mode="serve", serve_tp_only=tp_only))
        params = SH.shard_tree(tp, sh)
        got, gc = steps.make_prefill_step(tcfg, mesh=mesh,
                                          mesh_cfg=mesh.config)(
            params, {"tokens": tt})
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        dec = steps.make_decode_step(tcfg, mesh=mesh, mesh_cfg=mesh.config,
                                     moe_ep_data=True)
        a, _ = dec(params, tt[:, :1], steps.grow_decode_cache(
            tcfg, gc, B, S + 1))
        b, _ = dec(tp, tt[:, :1], steps.grow_decode_cache(tcfg, wc, B, S + 1))
        torch.testing.assert_close(a, b, rtol=0, atol=0)
