"""The port's sharding rules, meshes, placement and collectives against the
JAX package's.

* ``param_pspecs`` (train; serve with ``serve_tp_only`` True, False and
  decided by the budget, at the reference's 12 GiB; ``moe_ep_data``),
  ``batch_pspecs`` and ``cache_pspecs`` for every ``ARCH_IDS`` full
  configuration on ``SINGLE_POD_MESH`` and ``MULTI_POD_MESH``: the
  reference's from ``jax.eval_shape``, the port's from a model and
  inputs on the ``meta`` device; the port's parameter spec is the
  reference's with the stacked layer axis taken out;
* ``fits``, ``pick`` and ``moe_sharding_plan``;
* ``launch/mesh.py``'s shapes and axis names;
* ``shard_tensor``: each coordinate's block equals the shard
  ``jax.device_put`` gives the device at the same coordinate of a mesh
  of the same shape; ``unshard_tensor`` inverts it, autograd included;
* the collectives against ``lax`` collectives inside a ``shard_map``,
  and their byte counts.
"""
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from conftest import need_devices  # noqa: E402
from repro import config as JC  # noqa: E402
from repro.compat import shard_map  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import moe as JMO  # noqa: E402
from repro_torch import config as TC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed import collectives as CO  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.launch import specs as TSP  # noqa: E402
from repro_torch.models import moe as TMO  # noqa: E402
from repro_torch.models.transformer import empty_params  # noqa: E402

MESHES = {"pod1": (JC.SINGLE_POD_MESH, TC.SINGLE_POD_MESH),
          "pod2": (JC.MULTI_POD_MESH, TC.MULTI_POD_MESH)}
REF_BUDGET = 12 * 2**30          # the reference's SERVE_TP_ONLY_BUDGET
MODES = {"train": dict(mode="train"),
         "serve_tp_only": dict(mode="serve", serve_tp_only=True),
         "serve_fsdp": dict(mode="serve", serve_tp_only=False),
         "serve_budget": dict(mode="serve"),
         "moe_ep_data": dict(mode="serve", moe_ep_data=True)}

_ARCH = {}


def arch_pair(arch):
    """(jax cfg, port cfg, jax shape tree, port model on meta), once."""
    if arch not in _ARCH:
        jcfg, tcfg = JC.full_config(arch), TC.full_config(arch)
        sds = jax.eval_shape(partial(j_init_params, jcfg),
                             jax.random.PRNGKey(0))
        _ARCH[arch] = (jcfg, tcfg, sds, empty_params(tcfg, "meta"))
    return _ARCH[arch]


def spec_pairs(ref_tree, names):
    """(reference spec, port parameter name, stacked) for every leaf."""
    if isinstance(names, dict):
        assert set(names) == set(ref_tree)
        for k in names:
            yield from spec_pairs(ref_tree[k], names[k])
    elif isinstance(names, tuple):
        for n in names:
            yield ref_tree, n, True
    else:
        yield ref_tree, names, False


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_param_pspecs(arch, mesh, mode):
    jcfg, tcfg, sds, model = arch_pair(arch)
    jmc, tmc = MESHES[mesh]
    kw = MODES[mode]
    ref = JSH.param_pspecs(jcfg, sds, jmc, **kw)
    port = SH.param_pspecs(tcfg, model, tmc, budget=REF_BUDGET, **kw)
    assert list(port) == [k for k, _ in model.named_parameters()]
    n = 0
    for rspec, name, stacked in spec_pairs(ref, convert.param_names(model)):
        want = tuple(rspec)[1:] if stacked else tuple(rspec)
        assert not stacked or tuple(rspec)[0] is None
        assert tuple(port[name]) == want, (name, port[name], rspec)
        assert SH.fits(model.get_parameter(name).shape, port[name], tmc)
        n += 1
    assert n == len(port)


def test_serve_budget_is_the_h100s():
    """The default budget is 75% of the H100's 80 GB.  On 16 model
    coordinates grok-1 (633 GB of bf16 weights, 39.6 GB a coordinate) and
    deepseek-v2 (479 GB, 29.9 GB) then serve TP-only, where the
    reference's 12 GiB keeps their FSDP factors; the other eight decide
    alike under both budgets."""
    assert SH.SERVE_TP_ONLY_BUDGET == int(0.75 * 80e9)
    differ = set()
    for arch in JC.ARCH_IDS:
        _, tcfg, _, model = arch_pair(arch)
        a = SH.param_pspecs(tcfg, model, TC.SINGLE_POD_MESH, mode="serve")
        assert a == SH.param_pspecs(tcfg, model, TC.SINGLE_POD_MESH,
                                    mode="serve", serve_tp_only=True)
        b = SH.param_pspecs(tcfg, model, TC.SINGLE_POD_MESH, mode="serve",
                            budget=REF_BUDGET)
        if a != b:
            differ.add(arch)
    assert differ == {"grok-1-314b", "deepseek-v2-236b"}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", JC.ARCH_IDS)
def test_batch_and_cache_pspecs(arch, mesh):
    jcfg, tcfg, _, _ = arch_pair(arch)
    jmc, tmc = MESHES[mesh]
    for name, shape in JC.SHAPES.items():
        tshape = TC.SHAPES[name]
        if not JC.shape_applicable(jcfg, shape)[0]:
            continue
        if shape.kind == "decode":
            _, jcache = JSP.decode_input_specs(jcfg, shape)
            _, tcache = TSP.decode_input_specs(tcfg, tshape)
            ref = JSH.cache_pspecs(jcfg, jcache, jmc)
            port = SH.cache_pspecs(tcfg, tcache, tmc)
        else:
            ref = JSH.batch_pspecs(jcfg, JSP.input_specs(jcfg, shape), jmc)
            port = SH.batch_pspecs(tcfg, TSP.input_specs(tcfg, tshape), tmc)
        assert {k: tuple(v) for k, v in port.items()} == \
            {k: tuple(v) for k, v in ref.items()}, name


def _named(spec, mesh_cfg) -> bool:
    return all(a in mesh_cfg.axis_names for x in spec if x
               for a in (x if isinstance(x, tuple) else (x,)))


def test_fits_pick_and_plans():
    cases = [((32, 64), ("data", "model")), ((30, 64), ("data", None)),
             ((32, 6), (None, "model")), ((64, 8), (("pod", "data"), None)),
             ((16, 8), (("pod", "data"), "model"))]
    cands = [(("pod", "data"), "model"), ("data", None), ("model",)]
    for jmc, tmc in MESHES.values():
        for shape, spec in cases:
            if _named(spec, tmc):
                assert SH.fits(shape, SH.P(*spec), tmc) == \
                    JSH.fits(shape, JP(*spec), jmc)
        for shape in [(32, 64), (30, 64), (7, 3), (256, 16)]:
            ok = [c for c in cands if _named(c, tmc)]
            assert tuple(SH.pick(shape, [SH.P(*c) for c in ok], tmc)) == \
                tuple(JSH.pick(shape, [JP(*c) for c in ok], jmc))
    for arch in JC.ARCH_IDS:
        if JC.full_config(arch).family != "moe":
            continue
        for m in (1, 2, 3, 8, 16, 32):
            assert TMO.moe_sharding_plan(TC.full_config(arch), m) == \
                JMO.moe_sharding_plan(JC.full_config(arch), m)


def test_partition_spec_entries():
    assert tuple(SH.P(("data",), "model", None)) == tuple(
        JP(("data",), "model", None))
    assert tuple(SH.P((), ("pod", "data"))) == tuple(JP((), ("pod", "data")))
    assert tuple(SH.P()) == tuple(JP())


def test_launch_meshes():
    single = LM.make_production_mesh(devices=("cpu",))
    multi = LM.make_production_mesh(multi_pod=True, devices=("cpu",))
    assert (single.shape, single.axis_names) == ((16, 16), ("data", "model"))
    assert (multi.shape, multi.axis_names) == ((2, 16, 16),
                                               ("pod", "data", "model"))
    assert single.size() == 256 and multi.size() == 512
    assert single.distinct_devices == (torch.device("cpu"),)
    assert LM.mesh_config() == TC.SINGLE_POD_MESH
    assert LM.mesh_config(multi_pod=True) == TC.MULTI_POD_MESH
    assert multi.config == TC.MULTI_POD_MESH
    m = LM.make_mesh_from_config(TC.MeshConfig((4, 2), ("data", "model")),
                                 devices=("cpu",))
    assert (m.shape, m.size("data"), m.size("model")) == ((4, 2), 4, 2)
    smoke = LM.make_smoke_mesh(devices=("cpu",))
    assert (smoke.shape, smoke.axis_names) == ((2, 2), ("data", "model"))
    assert smoke.config.data_axes == ("data",)
    with pytest.raises(ValueError):
        SH.lm_mesh((2, 3), ("data", "model"), devices=("cpu", "meta"))
    with pytest.raises(ValueError):
        SH.lm_mesh((2, 3), ("data", "data"), devices=("cpu",))
    rr = SH.lm_mesh((5,), ("model",), devices=("meta", "cpu", "cpu")[1:])
    assert rr.devices == (torch.device("cpu"),) * 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            LM.make_smoke_mesh()


PLACE = [((2, 4), ("data", "model"), ("data", "model", None)),
         ((2, 4), ("data", "model"), ("model", None)),
         ((2, 4), ("data", "model"), (None, ("data", "model"))),
         ((2, 2, 2), ("pod", "data", "model"),
          (("pod", "data"), None, "model")),
         ((2, 2, 2), ("pod", "data", "model"), (None, "data"))]


@pytest.mark.parametrize("shape,names,spec", PLACE, ids=str)
def test_shard_tensor_matches_device_put(shape, names, spec):
    need_devices(8)
    jm = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape))
    tm = SH.lm_mesh(shape, names, devices=("cpu",))
    a = np.arange(8 * 8 * 4, dtype=np.float32).reshape(8, 8, 4)
    ja = jax.device_put(jnp.asarray(a), NamedSharding(jm, JP(*spec)))
    by_dev = {s.device: np.asarray(s.data) for s in ja.addressable_shards}
    x = torch.from_numpy(a).requires_grad_()
    st = SH.shard_tensor(x, SH.Sharding(tm, SH.P(*spec)))
    for c in tm.coords():
        np.testing.assert_array_equal(st.shards[c].detach().numpy(),
                                      by_dev[jm.devices[c]])
    whole = SH.unshard_tensor(st)
    assert torch.equal(whole, x)
    (whole * torch.arange(whole.numel()).reshape(whole.shape)).sum() \
        .backward()
    assert torch.equal(x.grad, torch.arange(x.numel()).reshape(x.shape)
                       .float())


def test_shard_tree_copies_and_dedups():
    tm = SH.lm_mesh((2, 2), ("data", "model"), devices=("cpu",))
    x = torch.arange(16.0).reshape(4, 4)
    st = SH.shard_tree({"a": x}, {"a": SH.Sharding(tm, SH.P("data"))})["a"]
    # replicas over model on one device are one tensor, a copy of x's rows
    assert st.shards[(0, 0)] is st.shards[(0, 1)]
    assert st.shards[(0, 0)] is not st.shards[(1, 0)]
    st.shards[(0, 0)].zero_()
    assert float(x.sum()) == 120.0         # the caller's tensor untouched
    with pytest.raises(ValueError):
        SH.shard_tensor(torch.zeros(3, 4), SH.Sharding(tm, SH.P("data")))


def _coord_values(tm, shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {c: rng.standard_normal(shape).astype(dtype) for c in tm.coords()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_collectives_match_lax(dtype):
    """all_gather, psum, pmean and psum_scatter over each axis of a
    (2, 4) mesh against ``lax``'s inside a ``shard_map``, bit for bit:
    each coordinate's block drawn apart, stacked on a leading axis that
    the mesh splits."""
    need_devices(8)
    shape, names = (2, 4), ("data", "model")
    jm = jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * 2)
    tm = SH.lm_mesh(shape, names, devices=("cpu",))
    vals = _coord_values(tm, (4, 8), 0)
    stacked = np.stack([np.stack([vals[(i, j)] for j in range(4)])
                        for i in range(2)])                  # (2, 4, 4, 8)
    jdt = jnp.dtype(dtype)
    xs = {c: torch.from_numpy(v).to(getattr(torch, dtype))
          for c, v in vals.items()}
    spec = JP("data", "model")
    for axis in names:
        def body(x):
            x = x[0, 0]
            return tuple(f(x)[None, None] for f in (
                lambda v: jax.lax.all_gather(v, axis, axis=0, tiled=True),
                lambda v: jax.lax.psum(v, axis),
                lambda v: jax.lax.pmean(v, axis),
                lambda v: jax.lax.psum_scatter(v, axis, scatter_dimension=1,
                                               tiled=True)))
        outs = jax.jit(shard_map(body, mesh=jm, in_specs=(spec,),
                                 out_specs=(spec,) * 4, check_vma=False))(
            jnp.asarray(stacked, jdt))
        ours = (CO.all_gather(tm, xs, axis, 0), CO.psum(tm, xs, axis),
                CO.pmean(tm, xs, axis), CO.psum_scatter(tm, xs, axis, 1))
        for got, ref in zip(ours, outs):
            for c in tm.coords():
                np.testing.assert_array_equal(
                    got[c].float().numpy(), np.asarray(ref[c], np.float32))


def test_collectives_order_and_bytes():
    tm = SH.lm_mesh((2, 3), ("data", "model"), devices=("cpu",))
    bf = torch.bfloat16
    xs = {c: torch.full((6,), [1.0, 2 ** -8, 2 ** -8][c[1]], dtype=bf)
          for c in tm.coords()}
    # summed in float32, rounded once: 1 + 2^-7, where bfloat16 adds
    # would round 1 + 2^-8 to 1 (ties to even) twice
    s = CO.psum(tm, xs, "model")
    assert all(float(s[c][0]) == 1 + 2 ** -7 for c in tm.coords())
    assert s[(0, 0)].dtype == bf
    assert s[(0, 0)] is s[(0, 2)]          # one result per group and device
    assert tm.traffic["psum"] == 6 * int(2 * 2 / 3 * 6 * 2)
    g = CO.all_gather(tm, xs, "data", 0)
    assert g[(0, 1)].shape == (12,)
    assert tm.traffic["all_gather"] == 6 * 1 * 12
    sc = CO.psum_scatter(tm, {c: torch.arange(6.0) for c in tm.coords()},
                         "model", 0)
    assert torch.equal(sc[(1, 2)], torch.tensor([12.0, 15.0]))
    assert tm.traffic["psum_scatter"] == 6 * int(2 / 3 * 24)
    one = SH.lm_mesh((1, 3), ("data", "model"), devices=("cpu",))
    CO.all_gather(one, {c: torch.ones(2) for c in one.coords()}, "data", 0)
    assert "all_gather" not in one.traffic


def test_collectives_are_differentiable():
    tm = SH.lm_mesh((1, 2), ("data", "model"), devices=("cpu",))
    a = torch.tensor([1.0, 2.0], requires_grad=True)
    b = torch.tensor([3.0, 4.0], requires_grad=True)
    g = CO.all_gather(tm, {(0, 0): a, (0, 1): b}, "model", 0)
    (g[(0, 0)] * torch.arange(4.0)).sum().backward()
    assert torch.equal(a.grad, torch.tensor([0.0, 1.0]))
    assert torch.equal(b.grad, torch.tensor([2.0, 3.0]))

