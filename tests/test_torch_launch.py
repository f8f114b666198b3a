"""The port's training driver and its parts against the JAX package's.

* ``FaultTolerantLoop`` on the same (step, wall, loss) sequences, NaN and
  inf included: histories, rollback decisions and counts, straggler flags
  and the straggler report equal;
* ``asdict(run_config_from_args(...))`` for every arch x shape x
  ``--multi-pod`` x ``--smoke``;
* ``input_specs`` and ``decode_input_specs`` (bf16 and int8 caches) for
  every arch x shape, full and smoke: the port's ``meta`` tensors have
  the reference's ``ShapeDtypeStruct`` shapes and dtypes, and
  ``should_quantize_kv`` agrees;
* both drivers' ``main`` on the olmo-1b and mamba2-370m smoke configs at
  float32 (the same ``dtype`` replacement applied to both through their
  ``get_arch``), 6 steps, ``--ckpt-every 2 --log-every 1``, the port
  started from the reference's initial tree (``make_params`` replaced):
  per-step losses within 1e-4, the same steps checkpointed, every leaf
  of every checkpoint within 1e-4 of the leaf's largest value;
* the same runs with a non-finite loss injected at chosen steps: in the
  reference through a stand-in for ``repro.launch.train``'s module global
  ``jax`` whose ``jit`` wraps the jitted step, in the port by wrapping
  ``make_train_step``; the same rollback count and checkpoints, and in
  the port the state after each rollback bit-equal to the last
  checkpointed step's (or, before any, to the state before the bad
  step), and past ``max_retries`` the bad step's result kept.

The reference compiles its step once per (config, TrainConfig): its
``make_train_step`` is memoised, so its repeated ``jax.jit`` hits the
compile cache.
"""
import argparse
import dataclasses
import json
import math
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.train as JTRAIN  # noqa: E402
from repro import config as JCF  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.distributed import fault as JF  # noqa: E402
from repro.launch import specs as JSPEC  # noqa: E402
from repro.runtime.steps import make_train_step as j_make_train_step  # noqa: E402,E501
from repro_torch import config as TCF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.distributed import fault as TF  # noqa: E402
from repro_torch.launch import specs as TSPEC  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402

TOL = 1e-4
DRIVER_ARCHS = ["olmo-1b", "mamba2-370m"]
STEPS, BATCH, SEQ, CKPT_EVERY = 6, 4, 32, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- FaultTolerantLoop ------------------------------------------------------

def _sequence(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    walls = rng.lognormal(-2.0, 0.3, n)
    walls[rng.integers(0, n, 3)] *= 4.0          # stragglers
    losses = 5.0 - 0.05 * np.arange(n) + rng.normal(0, 0.1, n)
    losses[rng.integers(0, n, 4)] = [math.nan, math.inf, -math.inf,
                                     math.nan]
    return list(zip(range(n), walls.tolist(), losses.tolist()))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("policy", [{}, {"max_retries": 0},
                                    {"max_retries": 5,
                                     "straggler_ewma": 0.5,
                                     "straggler_threshold": 1.1}])
def test_fault_tolerant_loop_matches_the_reference(seed, policy):
    loops = [mod.FaultTolerantLoop(mod.FaultPolicy(**policy))
             for mod in (JF, TF)]
    for step, wall, loss in _sequence(seed):
        straggling = [lp.is_straggling(wall) for lp in loops]
        hs = [lp.observe(step, wall, loss) for lp in loops]
        rollback = [lp.should_rollback(h) for lp, h in zip(loops, hs)]
        assert straggling[0] == straggling[1]
        assert rollback[0] == rollback[1]
        np.testing.assert_equal(dataclasses.astuple(hs[1]),
                                dataclasses.astuple(hs[0]))
    j, t = loops
    assert t.rollbacks == j.rollbacks and t.ewma_wall == j.ewma_wall
    np.testing.assert_equal([dataclasses.astuple(h) for h in t.history],
                            [dataclasses.astuple(h) for h in j.history])
    assert t.straggler_report() == j.straggler_report()
    assert TF.FaultTolerantLoop().straggler_report() \
        == JF.FaultTolerantLoop().straggler_report()
    assert dataclasses.asdict(TF.FaultPolicy(**policy)) \
        == dataclasses.asdict(JF.FaultPolicy(**policy))


# --- run configs and specs --------------------------------------------------

def _args(mod, argv):
    ap = argparse.ArgumentParser()
    mod.add_common_args(ap)
    return ap.parse_args(argv)


@pytest.mark.parametrize("shape", list(JCF.SHAPES))
@pytest.mark.parametrize("arch", JCF.ARCH_IDS)
def test_run_config_from_args_matches_the_reference(arch, shape):
    for flags in ([], ["--multi-pod"], ["--smoke"],
                  ["--multi-pod", "--smoke"]):
        argv = ["--arch", arch, "--shape", shape] + flags
        want = JCF.asdict(JCF.run_config_from_args(_args(JCF, argv)))
        got = TCF.asdict(TCF.run_config_from_args(_args(TCF, argv)))
        assert got == want, flags
    assert TCF.asdict(TCF.RunConfig(TCF.full_config(arch),
                                    TCF.SHAPES[shape])) \
        == JCF.asdict(JCF.RunConfig(JCF.full_config(arch),
                                    JCF.SHAPES[shape]))


def _same_specs(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        t = got[k]
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(w.shape), k
        assert str(t.dtype).removeprefix("torch.") == str(np.dtype(w.dtype)), k


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("shape", list(JCF.SHAPES))
@pytest.mark.parametrize("arch", JCF.ARCH_IDS)
def test_input_and_decode_specs_match_the_reference(arch, shape, smoke):
    get = "smoke_config" if smoke else "full_config"
    jcfg, tcfg = getattr(JCF, get)(arch), getattr(TCF, get)(arch)
    jshape, tshape = JCF.SHAPES[shape], TCF.SHAPES[shape]
    _same_specs(TSPEC.input_specs(tcfg, tshape),
                JSPEC.input_specs(jcfg, jshape))
    for quant in (False, True):
        jt, jc = JSPEC.decode_input_specs(jcfg, jshape, quant)
        tt, tc = TSPEC.decode_input_specs(tcfg, tshape, quant)
        _same_specs({"tokens": tt}, {"tokens": jt})
        _same_specs(tc, jc)
    for n in (1, 16, 256, 512):
        assert TSPEC.should_quantize_kv(tcfg, tshape, n) \
            == JSPEC.should_quantize_kv(jcfg, jshape, n)
    assert TSPEC.KV_QUANT_THRESHOLD == JSPEC.KV_QUANT_THRESHOLD


# --- the drivers ------------------------------------------------------------

class _F32Entry:
    """An architecture entry whose configs are at float32."""

    def __init__(self, entry):
        self.entry = entry

    def smoke(self):
        return dataclasses.replace(self.entry.smoke(), dtype="float32")

    def full(self):
        return dataclasses.replace(self.entry.full(), dtype="float32")


_J_STEPS = {}


def _j_step(cfg, tc):
    if (cfg, tc) not in _J_STEPS:
        _J_STEPS[(cfg, tc)] = j_make_train_step(cfg, tc)
    return _J_STEPS[(cfg, tc)]


def _argv(arch, ckpt_dir):
    return ["--arch", arch, "--smoke", "--steps", str(STEPS), "--batch",
            str(BATCH), "--seq", str(SEQ), "--ckpt-every", str(CKPT_EVERY),
            "--log-every", "1", "--ckpt-dir", str(ckpt_dir)]


def _run_reference(monkeypatch, arch, ckpt_dir, bad=()):
    """The JAX package's driver; returns its loop, its initial tree (as
    float32 numpy) and its checkpoint directory."""
    seen = {}

    class Loop(JF.FaultTolerantLoop):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            seen["loop"] = self

    orig_init = JTRAIN.init_params

    def init_params(cfg, key):
        seen["init"] = orig_init(cfg, key)
        return seen["init"]

    def jit(fn):
        jitted, calls = jax.jit(fn), [0]

        def step(params, opt, batch):
            p, o, m = jitted(params, opt, batch)
            calls[0] += 1
            if calls[0] - 1 in bad:
                m = dict(m, loss=jnp.float32(math.nan))
            return p, o, m
        return step

    with monkeypatch.context() as mp:
        mp.setattr(JTRAIN, "init_params", init_params)
        mp.setattr(JTRAIN, "FaultTolerantLoop", Loop)
        mp.setattr(JTRAIN, "get_arch", lambda a: _F32Entry(JCF.get_arch(a)))
        mp.setattr(JTRAIN, "make_train_step", _j_step)
        mp.setattr(JTRAIN, "jax", types.SimpleNamespace(jit=jit,
                                                        random=jax.random))
        mp.setattr(sys, "argv", ["train"] + _argv(arch, ckpt_dir))
        JTRAIN.main()
    init = jax.tree.map(lambda a: np.asarray(a, np.float32), seen["init"])
    return seen["loop"], init


def _state(params, opt):
    return [t.detach().clone() for t in (*params.parameters(),
                                         *opt["m"].values(),
                                         *opt["v"].values(), opt["step"])]


def _run_port(monkeypatch, arch, ckpt_dir, init, bad=()):
    """The port's driver from the reference's initial tree; returns its
    run and, per step call, the state it was handed and the state it
    returned (copies)."""
    entered, left = [], []
    orig_make = TTRAIN.make_train_step

    def make_step(cfg, tc):
        step = orig_make(cfg, tc)

        def wrapped(params, opt, batch):
            entered.append(_state(params, opt))
            p, o, m = step(params, opt, batch)
            left.append(_state(p, o))
            if len(left) - 1 in bad:
                m = dict(m, loss=torch.tensor(math.nan))
            return p, o, m
        return wrapped

    with monkeypatch.context() as mp:
        mp.setattr(TTRAIN, "make_train_step", make_step)
        mp.setattr(TTRAIN, "get_arch", lambda a: _F32Entry(TCF.get_arch(a)))
        mp.setattr(TTRAIN, "make_params",
                   lambda cfg, seed, dev: convert.params_from_numpy(
                       init, cfg, dev))
        run = TTRAIN.main(_argv(arch, ckpt_dir) + ["--device", "cpu"])
    return run, entered, left


def _same_checkpoints(jdir, tdir):
    """The same steps checkpointed, the same leaves (names, shapes,
    dtypes), each within TOL of the leaf's largest value."""
    assert CheckpointManager(tdir).steps() == JManager(jdir).steps()
    for step in JManager(jdir).steps():
        d = {"j": jdir / f"step_{step:08d}", "t": tdir / f"step_{step:08d}"}
        man = {k: json.loads((v / "manifest.json").read_text())["leaves"]
               for k, v in d.items()}
        assert list(man["t"]) == list(man["j"])
        for name, meta in man["j"].items():
            want = np.load(d["j"] / meta["file"])
            got = np.load(d["t"] / man["t"][name]["file"])
            assert got.shape == want.shape, name
            assert man["t"][name]["dtype"] == meta["dtype"], name
            scale = float(np.abs(want).max()) or 1.0
            assert float(np.abs(got - want).max()) <= TOL * scale, \
                (step, name)


def _losses(loop):
    return np.array([h.loss for h in loop.history])


@pytest.fixture(scope="module", params=DRIVER_ARCHS)
def clean_runs(request, tmp_path_factory):
    arch = request.param
    mp = pytest.MonkeyPatch()
    root = tmp_path_factory.mktemp(arch)
    jloop, init = _run_reference(mp, arch, root / "jax")
    run, _, left = _run_port(mp, arch, root / "torch", init)
    mp.undo()
    return arch, root, init, jloop, run, left


def test_drivers_agree_on_the_smoke_configs(clean_runs):
    arch, root, _, jloop, run, _ = clean_runs
    np.testing.assert_allclose(_losses(run.loop), _losses(jloop),
                               rtol=TOL, atol=TOL)
    assert all(h.ok for h in run.loop.history)
    assert run.loop.rollbacks == jloop.rollbacks == 0
    assert [h.step for h in run.loop.history] == list(range(STEPS))
    name = TCF.smoke_config(arch).name
    _same_checkpoints(root / "jax" / name, root / "torch" / name)
    assert run.ckpt.steps() == [0, 2, 4]


def test_the_driver_restores_its_own_checkpoint(clean_runs):
    """The newest checkpoint restores into a fresh model bit-equal to the
    parameters the driver held at that step."""
    arch, _, _, _, run, left = clean_runs
    step = run.ckpt.latest_step()
    cfg = dataclasses.replace(TCF.smoke_config(arch), dtype="float32")
    like = TTRAIN.make_params(cfg, 7, "cpu")
    got = run.ckpt.restore(step, like)
    params = list(got.parameters())
    assert len(params) == len(list(run.params.parameters()))
    for p, want in zip(params, left[step]):
        assert p.dtype == want.dtype and torch.equal(p, want)


def _equal(a: list, b: list) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("bad", [(3,), (0,), (1, 2, 3)],
                         ids=["after-a-checkpoint", "before-any",
                              "past-max-retries"])
def test_rollback_matches_the_reference(monkeypatch, tmp_path, clean_runs,
                                        bad):
    arch, _, init, _, _, _ = clean_runs
    jloop, _ = _run_reference(monkeypatch, arch, tmp_path / "jax", bad)
    run, entered, left = _run_port(monkeypatch, arch, tmp_path / "torch",
                                   init, bad)
    assert run.loop.rollbacks == jloop.rollbacks == len(bad)
    np.testing.assert_allclose(_losses(run.loop), _losses(jloop),
                               rtol=TOL, atol=TOL)
    name = TCF.smoke_config(arch).name
    _same_checkpoints(tmp_path / "jax" / name, tmp_path / "torch" / name)
    # the port's own state around each bad step, bit for bit: back to the
    # last checkpointed step's, or to the state before the step, or (past
    # max_retries) the bad step's result kept
    retries = TF.FaultPolicy().max_retries
    last_good = None
    for i in range(STEPS - 1):
        if i not in bad:
            if i % CKPT_EVERY == 0:
                last_good = left[i]
            assert _equal(entered[i + 1], left[i]), i
            continue
        if sum(1 for j in bad if j <= i) > retries:
            assert _equal(entered[i + 1], left[i]), i
            continue
        want = last_good if last_good is not None else entered[i]
        assert not _equal(left[i], want), i     # the step wrote in place
        assert _equal(entered[i + 1], want), i


def test_the_driver_refuses_the_cpu_without_being_asked(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTRAIN.main(["--steps", "1"])
