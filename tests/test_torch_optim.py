"""The port's optimizer, schedule, data pipeline and memory plan against
the JAX package's, on the CPU.

* ``lr_schedule`` over steps 0 .. total + 10 for several configurations,
  float32: rtol 1e-6 (one cosine may round differently).
* ``adamw_update`` on seeded trees with the same gradients, float32 and
  bfloat16 parameters, clipping active and inactive, steps 1-3: float32
  parameters and moments at rtol 1e-5, atol 1e-7 (the float32 powers
  and divisions of the two libraries may differ in their last bit);
  bfloat16 parameters within one bfloat16 ulp (a last-bit difference
  before the cast may round the other way).
* ``SyntheticLMData`` and ``make_batch_iterator``: bit-equal batches for
  an LM, a vlm and an encdec configuration.
* ``estimate_train_bytes`` and ``auto_train_plan``: equal for every arch
  x train shape x mesh under the reference's 12 GiB budget, which the
  port takes as ``budget=``; the port's default is 75% of the H100's
  80 GB.
* ``optim/grad_compress.py``: ``quantize_int8``/``dequantize_int8``
  bit-equal; ``compressed_psum_leaf``'s result and error feedback over
  four steps against the reference's, bit for bit, in a ``shard_map``
  over a 1-D ("pod",) mesh; ``compressed_pod_mean`` on a pod/data/model
  mesh.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.data import make_batch_iterator as j_batches  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.optim import lr_schedule as j_lr_schedule  # noqa: E402
from repro.runtime import memplan as JMP  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch.data import SyntheticLMData as TData  # noqa: E402
from repro_torch.data import make_batch_iterator as t_batches  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim import lr_schedule  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402
from repro_torch.runtime import memplan as TMP  # noqa: E402

SCHEDULES = [dict(), dict(warmup_steps=0), dict(warmup_steps=3,
                                                total_steps=30),
             dict(warmup_steps=50, total_steps=50),
             dict(warmup_steps=1, total_steps=7, learning_rate=3e-3)]


def both(**kw):
    return JC.TrainConfig(**kw), TC.TrainConfig(**kw)


@pytest.mark.parametrize("kw", SCHEDULES, ids=[str(k) for k in SCHEDULES])
def test_lr_schedule(kw):
    jtc, ttc = both(**kw)
    steps = np.arange(ttc.total_steps + 11, dtype=np.int32)
    want = np.asarray(j_lr_schedule(jnp.asarray(steps), jtc))
    got = lr_schedule(torch.from_numpy(steps), ttc)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert float(got[0]) == 0.0          # the first update's rate


SHAPES = {"w": (16, 8), "b": (8,), "e": (32, 4, 3)}


def _tree(rng, scale):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("clip", ("inactive", "active"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_adamw_update(dtype, clip):
    """Three steps on the same seeded gradients; clipping is active when
    their global norm exceeds grad_clip = 1."""
    rng = np.random.default_rng(7)
    p0 = _tree(rng, 0.5)
    jtc, ttc = both(weight_decay=0.1, grad_clip=1.0)
    jp = {k: jnp.asarray(v, dtype) for k, v in p0.items()}
    tp = torch.nn.ParameterDict({
        k: torch.nn.Parameter(torch.from_numpy(v).to(getattr(torch, dtype)))
        for k, v in p0.items()})
    jo, to = j_adamw_init(jp), adamw_init(tp)
    for step, lr in zip((1, 2, 3), (1e-2, 3e-3, 5e-2)):
        g = _tree(rng, 0.01 if clip == "inactive" else 1.0)
        jg = {k: jnp.asarray(v, dtype) for k, v in g.items()}
        tg = {k: torch.from_numpy(v).to(getattr(torch, dtype))
              for k, v in g.items()}
        jp, jo, jn = j_adamw_update(jg, jo, jp, jnp.float32(lr), jtc)
        tp, to, tn = adamw_update(tg, to, tp, torch.tensor(lr), ttc)
        assert (float(jn) > 1.0) == (clip == "active")
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        assert int(to["step"]) == int(jo["step"]) == step
        for k in SHAPES:
            a = tp[k].detach().float().numpy()
            b = np.asarray(jp[k], np.float32)
            if dtype == "float32":
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
            else:   # one bf16 ulp: 2^-7 of the value's binade
                np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=0)
            for mom in ("m", "v"):
                np.testing.assert_allclose(
                    to[mom][k].numpy(), np.asarray(jo[mom][k]), rtol=1e-5,
                    atol=1e-7 * float(np.abs(np.asarray(jo[mom][k])).max()))


def test_adamw_update_slices_change_no_bits(monkeypatch):
    """The update runs on slices of UPDATE_CHUNK elements; elementwise
    math, so slices of 7 give the same bits as whole parameters."""
    from repro_torch.optim import adamw
    out = []
    for chunk in (adamw.UPDATE_CHUNK, 7):
        monkeypatch.setattr(adamw, "UPDATE_CHUNK", chunk)
        r = np.random.default_rng(3)
        tp = torch.nn.ParameterDict({k: torch.nn.Parameter(
            torch.from_numpy(v)) for k, v in _tree(r, 0.5).items()})
        to = adamw_init(tp)
        for lr in (1e-2, 3e-3):
            g = {k: torch.from_numpy(v) for k, v in _tree(r, 1.0).items()}
            tp, to, _ = adamw_update(g, to, tp, torch.tensor(lr),
                                     TC.TrainConfig())
        out.append((tp, to))
    (pa, oa), (pb, ob) = out
    for k in SHAPES:
        assert torch.equal(pa[k], pb[k])
        assert torch.equal(oa["m"][k], ob["m"][k])
        assert torch.equal(oa["v"][k], ob["v"][k])


@pytest.mark.parametrize("arch", ["llama3-8b", "llava-next-mistral-7b",
                                  "whisper-small"])
def test_batches_bit_equal(arch):
    """An LM, a vlm (patch embeddings, text cut to make room) and an
    encdec (frame embeddings) configuration: three steps' batches, and a
    host's slice of a global batch."""
    shape = JC.ShapeConfig("t", 64, 4, "train")
    cfg_j, cfg_t = JC.smoke_config(arch), TC.smoke_config(arch)
    it_j = j_batches(cfg_j, shape, seed=5)
    it_t = t_batches(cfg_t, TC.ShapeConfig("t", 64, 4, "train"), seed=5)
    for _ in range(3):
        bj, bt = next(it_j), next(it_t)
        assert sorted(bj) == sorted(bt)
        for k in bj:
            assert bj[k].dtype == bt[k].dtype
            np.testing.assert_array_equal(bj[k], bt[k])
    dj = JData(cfg_j.vocab_size, 48, 8, seed=2, host_index=1, host_count=2)
    dt = TData(cfg_t.vocab_size, 48, 8, seed=2, host_index=1, host_count=2)
    for k, v in dj.batch(3).items():
        np.testing.assert_array_equal(v, dt.batch(3)[k])


TRAIN_SHAPES = [s.name for s in JC.SHAPES.values() if s.kind == "train"]
MESHES = {"one": ((1, 1), ("data", "model")),
          "pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
PLANS = [dict(), dict(remat="block", microbatches=4),
         dict(remat="none", moment_dtype="bfloat16",
              grad_accum_dtype="bfloat16", microbatches=2)]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_memplan(arch, mesh):
    cfg_j, cfg_t = JC.full_config(arch), TC.full_config(arch)
    mj, mt = JC.MeshConfig(*MESHES[mesh]), TC.MeshConfig(*MESHES[mesh])
    shapes = [(JC.SHAPES[n], TC.SHAPES[n]) for n in TRAIN_SHAPES] + [
        (JC.ShapeConfig("t", 2048, 4, "train"),
         TC.ShapeConfig("t", 2048, 4, "train"))]
    for sj, st in shapes:
        for kw in PLANS:
            jtc, ttc = both(**kw)
            assert TMP.estimate_train_bytes(cfg_t, st, mt, ttc) == \
                JMP.estimate_train_bytes(cfg_j, sj, mj, jtc), (sj, kw)
        got = TMP.auto_train_plan(cfg_t, st, mt, budget=JMP.HBM_BUDGET)
        want = JMP.auto_train_plan(cfg_j, sj, mj)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), sj


def test_memplan_budget():
    """The port's default budget is the reference's 75% of one device,
    of the H100's 80 GB instead of the TPU's 16 GiB: mamba2-370m's 4 x
    2048 step fits one card with float32 moments and no microbatching,
    llama3-8b's 256 x 4096 step fits nowhere near (the most frugal
    plan)."""
    assert JMP.HBM_BUDGET == 0.75 * 16 * 2 ** 30
    assert TMP.HBM_BUDGET == int(0.75 * hw.HBM_PER_CHIP) == 60_000_000_000
    mesh = TC.MeshConfig((1, 1), ("data", "model"))
    shape = TC.ShapeConfig("t", 2048, 4, "train")
    plan = TMP.auto_train_plan(TC.full_config("mamba2-370m"), shape, mesh)
    assert (plan.microbatches, plan.moment_dtype, plan.remat) == \
        (1, "float32", "block")
    big = TMP.auto_train_plan(TC.full_config("llama3-8b"),
                              TC.SHAPES["train_4k"], mesh)
    assert (big.microbatches, big.moment_dtype, big.grad_accum_dtype) == \
        (64, "bfloat16", "bfloat16")


# --- int8 gradient compression (optim/grad_compress.py) -----------------------

def _pod_values(n, shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for _ in range(n)]


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_quantize_int8_bit_equal(scale):
    from repro.optim import grad_compress as JG
    from repro_torch.optim import grad_compress as TG
    x = _pod_values(1, (37, 5), 4, scale)[0]
    jq, js = JG.quantize_int8(jnp.asarray(x))
    tq, ts = TG.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(TG.dequantize_int8(tq, ts).numpy(),
                                  np.asarray(JG.dequantize_int8(jq, js)))


@pytest.mark.parametrize("n_pods", [2, 4])
def test_compressed_psum_leaf_with_error_feedback(n_pods):
    """Four steps of each pod's own gradient through the compressed pod
    mean, each step's error fed back: the port's per-coordinate result
    and error against the reference's ``compressed_psum_leaf`` in a
    ``shard_map`` over a 1-D ("pod",) mesh, the pods' values stacked on a
    leading axis that the mesh splits: bit for bit."""
    from conftest import need_devices
    from jax.sharding import AxisType
    from jax.sharding import PartitionSpec as JP
    from repro.compat import shard_map
    from repro.optim import grad_compress as JG
    from repro_torch.distributed import sharding as SH
    from repro_torch.optim import grad_compress as TG
    need_devices(n_pods)
    jm = jax.make_mesh((n_pods,), ("pod",), axis_types=(AxisType.Auto,))
    tm = SH.lm_mesh((n_pods,), ("pod",), devices=("cpu",))

    def body(g, e):
        r, ne = JG.compressed_psum_leaf(g[0], e[0], "pod")
        return r[None], ne[None]

    step = jax.jit(shard_map(body, mesh=jm, in_specs=(JP("pod"), JP("pod")),
                             out_specs=(JP("pod"), JP("pod")),
                             check_vma=False))
    je = jnp.zeros((n_pods, 6, 10), jnp.float32)
    te = {c: torch.zeros(6, 10) for c in tm.coords()}
    for s in range(4):
        gs = _pod_values(n_pods, (6, 10), 10 + s, scale=10.0 ** -s)
        jr, je = step(jnp.asarray(np.stack(gs)), je)
        tr, te = TG.compressed_psum_leaf(
            tm, {(i,): torch.from_numpy(g) for i, g in enumerate(gs)}, te)
        for i in range(n_pods):
            np.testing.assert_array_equal(tr[(i,)].numpy(), np.asarray(jr[i]))
            np.testing.assert_array_equal(te[(i,)].numpy(), np.asarray(je[i]))
    assert tm.traffic["psum"] > 0 and tm.traffic["pmean"] > 0


def test_compressed_pod_mean_on_a_pod_data_model_mesh():
    """On a (2, 2, 2) pod/data/model mesh (where the reference's
    ``shard_map`` over pod alone fails under jax 0.9): a tree of a
    ShardedTensor, whose two pods hold different values, and a tensor
    every coordinate holds alike.  Every coordinate gets its pod group's
    ``compressed_psum_leaf`` on a 1-D pod mesh; ``init_error_state`` is
    float32 zeros shaped as each leaf."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.optim import grad_compress as TG
    tm = SH.lm_mesh((2, 2, 2), ("pod", "data", "model"), devices=("cpu",))
    pods = SH.lm_mesh((2,), ("pod",), devices=("cpu",))
    per_pod = [torch.from_numpy(v) for v in _pod_values(2, (8, 4), 1)]
    sh = SH.Sharding(tm, SH.P("data", "model"))
    shards = {}
    for c in tm.coords():
        blk = SH.shard_tensor(per_pod[c[0]], sh).shards[c]
        shards[c] = blk
    g = {"w": SH.ShardedTensor(sh, torch.Size((8, 4)), shards),
         "b": torch.arange(6.0)}
    err = TG.init_error_state(g)
    assert err["b"].dtype == torch.float32 and err["b"].shape == (6,)
    assert set(err["w"].shards) == set(tm.coords())
    new_g, new_e = TG.compressed_pod_mean(g, err, tm)
    for c in tm.coords():
        want, want_e = TG.compressed_psum_leaf(
            pods, {(i,): shards[(i,) + c[1:]] for i in range(2)},
            {(i,): torch.zeros(shards[c].shape) for i in range(2)})
        assert torch.equal(new_g["w"].shards[c], want[(c[0],)])
        assert torch.equal(new_e["w"].shards[c], want_e[(c[0],)])
    b, _ = TG.compressed_psum_leaf(
        pods, {(i,): torch.arange(6.0) for i in range(2)},
        {(i,): torch.zeros(6) for i in range(2)})
    assert torch.equal(new_g["b"], b[(0,)])
    with pytest.raises(ValueError, match="pod"):
        TG.compressed_pod_mean(g, err, SH.lm_mesh((2, 2), ("data", "model"),
                                                  devices=("cpu",)))
