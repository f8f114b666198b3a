"""The port's checkpoint manager against the JAX package's.

One for one, the 11 tests of ``tests/test_checkpoint.py`` and the two
checkpoint tests of ``tests/test_sharding_infra.py``, each on numpy trees
and on tensor trees (the port's ``Model`` for the sharding ones).  Then
the cross-package cases: for the olmo-1b (bfloat16) and mamba2-370m smoke
configs, the JAX package's ``save`` of its ``init_params`` tree and the
port's ``save`` of ``convert.params_from_numpy`` of the same tree give
byte-identical step directories, and each package restores the other's
checkpoint bit for bit; and a tensor written in place between ``save``
and ``wait`` leaves the checkpoint holding the old values.  Last,
``restore(..., shardings=)``: a model or a tree of ``ShardedTensor``\\ s
saved from one mesh restores onto meshes of other shapes bit for bit,
and each package reshards the other's checkpoint.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as JM  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.config import smoke_config as jax_smoke_config  # noqa: E402
from repro_torch import config as TCF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import (CheckpointError,  # noqa: E402
                                    CheckpointManager)
from repro_torch.checkpoint import manager as M  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.models import init_params  # noqa: E402

KINDS = ["numpy", "tensor"]


def _tree(seed: int = 0, kind: str = "numpy"):
    rng = np.random.default_rng(seed)
    tree = {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(3,)).astype(np.float32),
            "opt": {"mu": rng.normal(size=(4, 3)).astype(np.float32)}}
    if kind == "tensor":
        return {"w": torch.from_numpy(tree["w"]),
                "b": torch.from_numpy(tree["b"]),
                "opt": {"mu": torch.from_numpy(tree["opt"]["mu"])}}
    return tree


def _save(mgr, step: int, seed: int, kind: str):
    tree = _tree(seed, kind)
    mgr.save(step, tree, blocking=True)
    return tree


def _np(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _assert_trees_equal(a, b):
    assert np.array_equal(_np(a["w"]), _np(b["w"]))
    assert np.array_equal(_np(a["b"]), _np(b["b"]))
    assert np.array_equal(_np(a["opt"]["mu"]), _np(b["opt"]["mu"]))


# --- tests/test_checkpoint.py, one for one ---------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_save_restore_roundtrip(tmp_path, kind):
    mgr = CheckpointManager(tmp_path, keep=3)
    tree = _save(mgr, 10, 1, kind)
    assert mgr.latest_step() == 10
    got = mgr.restore(10, _tree(99, kind))
    _assert_trees_equal(got, tree)
    assert type(got["w"]) is type(tree["w"])


@pytest.mark.parametrize("kind", KINDS)
def test_steps_listing_and_gc(tmp_path, kind):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3):
        _save(mgr, s, s, kind)
    assert mgr.steps() == [2, 3]          # keep=2 dropped step 1
    assert mgr.latest_step() == 3


@pytest.mark.parametrize("kind", KINDS)
def test_truncated_leaf_raises_checkpoint_error(tmp_path, kind):
    mgr = CheckpointManager(tmp_path, keep=3)
    _save(mgr, 5, 0, kind)
    leaf = next((tmp_path / "step_00000005").glob("leaf_*.npy"))
    leaf.write_bytes(leaf.read_bytes()[:16])   # truncate mid-header
    with pytest.raises(CheckpointError):
        mgr.restore(5, _tree(0, kind))


@pytest.mark.parametrize("kind", KINDS)
def test_shape_mismatch_raises_checkpoint_error(tmp_path, kind):
    mgr = CheckpointManager(tmp_path, keep=3)
    _save(mgr, 5, 0, kind)
    d = tmp_path / "step_00000005"
    manifest = json.loads((d / "manifest.json").read_text())
    name, meta = next(iter(manifest["leaves"].items()))
    np.save(d / meta["file"], np.zeros((1,), dtype=np.float32))
    with pytest.raises(CheckpointError, match="shape"):
        mgr.restore(5, _tree(0, kind))


@pytest.mark.parametrize("kind", KINDS)
def test_corrupt_manifest_raises_checkpoint_error(tmp_path, kind):
    mgr = CheckpointManager(tmp_path, keep=3)
    _save(mgr, 5, 0, kind)
    (tmp_path / "step_00000005" / "manifest.json").write_text("{not json")
    with pytest.raises(CheckpointError, match="manifest"):
        mgr.restore(5, _tree(0, kind))


@pytest.mark.parametrize("kind", KINDS)
def test_restore_latest_falls_back_past_corrupt_step(tmp_path, kind):
    mgr = CheckpointManager(tmp_path, keep=3)
    good = _save(mgr, 7, 7, kind)
    _save(mgr, 8, 8, kind)
    # the newest checkpoint was truncated by a crash mid-write
    leaf = next((tmp_path / "step_00000008").glob("leaf_*.npy"))
    leaf.write_bytes(b"")
    with pytest.warns(RuntimeWarning, match="corrupt"):
        step, tree = mgr.restore_latest(_tree(0, kind))
    assert step == 7
    _assert_trees_equal(tree, good)


@pytest.mark.parametrize("kind", KINDS)
def test_restore_latest_empty_dir_returns_none(tmp_path, kind):
    mgr = CheckpointManager(tmp_path)
    assert mgr.restore_latest(_tree(0, kind)) == (None, None)


@pytest.mark.parametrize("kind", KINDS)
def test_restore_latest_all_corrupt_returns_none(tmp_path, kind):
    mgr = CheckpointManager(tmp_path, keep=3)
    _save(mgr, 1, 1, kind)
    next((tmp_path / "step_00000001").glob("leaf_*.npy")).write_bytes(b"")
    with pytest.warns(RuntimeWarning):
        assert mgr.restore_latest(_tree(0, kind)) == (None, None)


@pytest.mark.parametrize("kind", KINDS)
def test_incomplete_step_dir_is_invisible(tmp_path, kind):
    mgr = CheckpointManager(tmp_path, keep=3)
    _save(mgr, 3, 3, kind)
    # a crash before the manifest write leaves no manifest.json
    broken = tmp_path / "step_00000009"
    broken.mkdir()
    np.save(broken / "leaf_00000.npy", np.zeros(2))
    assert mgr.steps() == [3]
    assert mgr.latest_step() == 3


@pytest.mark.parametrize("kind", KINDS)
def test_async_write_failure_surfaces_via_wait(tmp_path, kind):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _tree(0, kind), blocking=False)
    mgr.wait()
    mgr._write_error = OSError("disk full")   # simulate a thread failure
    with pytest.raises(CheckpointError, match="disk full"):
        mgr.wait()
    # the error is consumed: the manager is usable again
    mgr.save(2, _tree(0, kind), blocking=True)
    assert mgr.latest_step() == 2


def test_a_failed_background_write_surfaces_from_the_next_save(tmp_path):
    """A real failure on the writer thread (the step directory's place is
    taken by a file the writer cannot remove) comes back from save()."""
    mgr = CheckpointManager(tmp_path, keep=3)
    (tmp_path / ".tmp_step_00000004").write_text("in the way")
    mgr.save(4, _tree(), blocking=False)
    with pytest.raises(CheckpointError, match="background"):
        mgr.save(5, _tree())
    assert mgr.steps() == []
    # the error is consumed: the next save writes
    mgr.save(5, _tree(), blocking=True)
    assert mgr.steps() == [5]


@pytest.mark.parametrize("kind", KINDS)
def test_bf16_roundtrip_casts_back(tmp_path, kind):
    mgr = CheckpointManager(tmp_path, keep=2)
    if kind == "numpy":
        tree = {"p": np.asarray(jnp.ones((3,), dtype=jnp.bfloat16))}
    else:
        tree = {"p": torch.ones((3,), dtype=torch.bfloat16)}
    mgr.save(1, tree, blocking=True)
    manifest = json.loads((tmp_path / "step_00000001" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["p"]["dtype"] == "bfloat16"
    assert np.load(tmp_path / "step_00000001" / "leaf_00000.npy").dtype \
        == np.float32
    got = mgr.restore(1, tree)
    assert got["p"].dtype == tree["p"].dtype
    assert np.allclose(np.asarray(_np(got["p"]), dtype=np.float32), 1.0)


def test_restore_refuses_shardings(tmp_path):
    """A sharding whose split dims the leaf does not divide is refused,
    as ``jax.device_put`` refuses uneven shards (the (4, 3) ``w`` over a
    model axis of 2 on its last dim)."""
    mgr = CheckpointManager(tmp_path)
    _save(mgr, 1, 1, "tensor")
    mesh = SH.lm_mesh((1, 2), ("data", "model"), devices=("cpu",))
    bad = SH.Sharding(mesh, SH.P(None, "model"))
    with pytest.raises(ValueError, match="split"):
        mgr.restore(1, _tree(0, "tensor"),
                    shardings={"w": bad, "b": None, "opt": {"mu": None}})


# --- resharding restore ------------------------------------------------------

def _meshes():
    return {shape: SH.lm_mesh(shape, ("data", "model"), devices=("cpu",))
            for shape in ((2, 2), (1, 4), (4, 1), (1, 1))}


def test_restore_reshards_a_model_onto_any_mesh(tmp_path):
    """A model saved from shards on a (2, 2) mesh restores onto (1, 4),
    (4, 1) and one device: every shard bit-equal to the same block of the
    model, the files byte-identical to the unsharded model's."""
    cfg = TCF.smoke_config("grok-1-314b")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    meshes = _meshes()
    specs = SH.param_pspecs(cfg, model, meshes[(2, 2)].config)
    sharded = SH.shard_tree(model, SH.named_shardings(meshes[(2, 2)], specs))
    mgr = CheckpointManager(tmp_path / "sharded", keep=2)
    mgr.save(4, sharded, blocking=True)
    CheckpointManager(tmp_path / "whole").save(4, model, blocking=True)
    # a dict of ShardedTensors saves its leaves whole, under its own keys
    d = tmp_path / "sharded" / "step_00000004"
    assert set(json.loads((d / "manifest.json").read_text())["leaves"]) \
        == set(specs)
    CheckpointManager(tmp_path / "model").save(4, model, blocking=True)
    whole = dict(model.named_parameters())
    for shape, mesh in meshes.items():
        sh = SH.named_shardings(mesh, SH.param_pspecs(cfg, model,
                                                      mesh.config))
        for mgr_dir, like in (("model", model), ("sharded", sharded)):
            got = CheckpointManager(tmp_path / mgr_dir).restore(
                4, like, shardings=sh)
            assert set(got) == set(whole)
            for k, st in got.items():
                assert st.mesh is mesh and st.dtype == whole[k].dtype
                want = SH.shard_tensor(whole[k].detach(), sh[k])
                for c in mesh.coords():
                    assert torch.equal(st.shards[c], want.shards[c]), (k, c)
    assert _files(tmp_path / "whole" / "step_00000004") == \
        _files(tmp_path / "model" / "step_00000004")


def test_restore_latest_reshards_a_tree(tmp_path):
    """A tree of ShardedTensors (AdamW state) saved on (2, 2) comes back
    on its own sharding without ``shardings``, and on (1, 4) with it."""
    meshes = _meshes()
    rng = np.random.default_rng(3)
    m = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    step = torch.tensor(7, dtype=torch.int32)
    sh22 = {"m": SH.Sharding(meshes[(2, 2)], SH.P("data", "model")),
            "step": SH.Sharding(meshes[(2, 2)], SH.P())}
    tree = SH.shard_tree({"m": m, "step": step}, sh22)
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, tree, blocking=True)
    same = mgr.restore(2, tree)
    assert same["m"].sharding is sh22["m"]
    assert torch.equal(SH.unshard_tensor(same["m"]), m)
    sh14 = {"m": SH.Sharding(meshes[(1, 4)], SH.P(None, "model")),
            "step": None}
    n, got = mgr.restore_latest(tree, shardings=sh14)
    assert n == 2 and got["step"].sharding is sh22["step"]
    assert int(SH.unshard_tensor(got["step"])) == 7
    for c in meshes[(1, 4)].coords():
        assert torch.equal(got["m"].shards[c], m[:, c[1]:c[1] + 1])


def test_the_jax_package_and_the_port_reshard_each_others(tmp_path, both):
    """Each package restores the other's checkpoint onto a (4, 2) mesh
    with ``shardings=``: the port's shard at each coordinate bit-equal to
    the JAX array's shard on the device at that coordinate."""
    from jax.sharding import AxisType
    from repro.distributed import sharding as JSH
    from repro.config import MeshConfig as JMeshConfig
    arch, jp, model = both
    cfg = TCF.smoke_config(arch)
    jmc = JMeshConfig((4, 2), ("data", "model"))
    jm = jax.make_mesh((4, 2), ("data", "model"),
                       axis_types=(AxisType.Auto,) * 2)
    mesh = SH.lm_mesh((4, 2), ("data", "model"), devices=("cpu",))
    jsh = JSH.named_shardings(jm, JSH.param_pspecs(jax_smoke_config(arch),
                                                   jp, jmc))
    tsh = SH.named_shardings(mesh, SH.param_pspecs(cfg, model, mesh.config))
    CheckpointManager(tmp_path / "torch").save(1, model, blocking=True)
    JManager(tmp_path / "jax").save(1, jp, blocking=True)
    for src in ("torch", "jax"):
        ref = JManager(tmp_path / src).restore(1, jp, shardings=jsh)
        got = CheckpointManager(tmp_path / src).restore(1, model,
                                                        shardings=tsh)
        names = convert.param_names(model)
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
            node = names
            for key in path:
                node = node[key.key]
            for layer, name in enumerate(node if isinstance(node, tuple)
                                         else (node,)):
                by_dev = {sd.device: np.asarray(sd.data, np.float32)
                          for sd in leaf.addressable_shards}
                for c in mesh.coords():
                    want = by_dev[jm.devices[c]]
                    want = want[layer] if isinstance(node, tuple) else want
                    assert np.array_equal(
                        got[name].shards[c].float().numpy(), want), name


# --- tests/test_sharding_infra.py's two checkpoint tests --------------------

def test_checkpoint_roundtrip(tmp_path):
    cfg = TCF.smoke_config("olmo-1b")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(0, params, blocking=True)
    mgr.save(10, params, blocking=True)
    mgr.save(20, params, blocking=True)
    assert mgr.latest_step() == 20
    # keep=2 garbage-collects step 0
    assert not (tmp_path / "step_00000000").exists()
    restored = mgr.restore(20, params)
    assert restored is not params
    for (k, a), (k2, b) in zip(params.named_parameters(),
                               restored.named_parameters()):
        assert k == k2 and a.dtype == b.dtype
        assert torch.equal(a, b), k


def test_checkpoint_ignores_incomplete(tmp_path):
    mgr = CheckpointManager(tmp_path)
    (tmp_path / "step_00000099").mkdir()       # no manifest -> incomplete
    assert mgr.latest_step() is None


# --- across the packages ----------------------------------------------------

ARCHS = ["olmo-1b", "mamba2-370m"]


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    """The JAX package's init_params tree and the port's model from it."""
    arch = request.param
    jp = jax.jit(JM.init_params, static_argnums=0)(
        jax_smoke_config(arch), jax.random.PRNGKey(0))
    f32 = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return arch, jp, convert.params_from_numpy(
        f32, TCF.smoke_config(arch), "cpu")


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def test_step_directories_are_byte_identical(tmp_path, both):
    arch, jp, model = both
    JManager(tmp_path / "jax", keep=2).save(3, jp, blocking=True)
    CheckpointManager(tmp_path / "torch", keep=2).save(3, model,
                                                       blocking=True)
    want = _files(tmp_path / "jax" / "step_00000003")
    got = _files(tmp_path / "torch" / "step_00000003")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], (arch, name)
    manifest = json.loads(got["manifest.json"])
    dtypes = {m["dtype"] for m in manifest["leaves"].values()}
    assert "bfloat16" in dtypes


def test_the_port_restores_the_jax_packages_checkpoint(tmp_path, both):
    arch, jp, model = both
    JManager(tmp_path, keep=2).save(1, jp, blocking=True)
    like = init_params(TCF.smoke_config(arch),
                       torch.Generator().manual_seed(5), "cpu")
    got = CheckpointManager(tmp_path).restore(1, like)
    for (k, a), (_, b) in zip(model.named_parameters(),
                              got.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    # a tree of numpy arrays in the JAX package's layout restores too
    tree = CheckpointManager(tmp_path).restore(
        1, convert.params_to_numpy(like, TCF.smoke_config(arch)))
    want = convert.params_to_numpy(model, TCF.smoke_config(arch))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert np.array_equal(a, b)


def test_the_jax_package_restores_the_ports_checkpoint(tmp_path, both):
    arch, jp, model = both
    CheckpointManager(tmp_path, keep=2).save(1, model, blocking=True)
    like = jax.tree.map(jnp.zeros_like, jp)
    got = JManager(tmp_path).restore(1, like)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))


@pytest.fixture
def held_writer(monkeypatch):
    """The writer thread waits for the returned event before it converts
    the first leaf."""
    go = threading.Event()
    to_numpy = M._to_numpy

    def held(a):
        go.wait(timeout=60)
        return to_numpy(a)

    monkeypatch.setattr(M, "_to_numpy", held)
    return go


def test_a_tensor_written_after_save_leaves_the_checkpoint(tmp_path,
                                                          held_writer):
    tree = _tree(1, "tensor")
    old = {k: v.clone() for k, v in (("w", tree["w"]), ("b", tree["b"]))}
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, tree)
    tree["w"].add_(1.0)
    tree["b"].copy_(torch.zeros(3))
    held_writer.set()
    mgr.wait()
    got = mgr.restore(1, _tree(0, "tensor"))
    assert torch.equal(got["w"], old["w"]) and torch.equal(got["b"], old["b"])


def test_a_model_written_after_save_leaves_the_checkpoint(tmp_path,
                                                         held_writer):
    """At float32 on the CPU, ``.float()`` and ``.cpu()`` return the same
    tensor: the snapshot must copy, the stacked layers and the rest."""
    cfg = dataclasses.replace(TCF.smoke_config("mamba2-370m"),
                              dtype="float32")
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    old = {k: p.detach().clone() for k, p in model.named_parameters()}
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, model)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(-2.0)
    held_writer.set()
    mgr.wait()
    got = mgr.restore(2, model)
    for k, p in got.named_parameters():
        assert torch.equal(p, old[k]), k
