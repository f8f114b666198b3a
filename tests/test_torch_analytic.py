"""The port's analytic roofline (``repro_torch.roofline.analytic``), its
configuration copies (``repro_torch.config``, ``repro_torch.configs``)
and the ``train`` and ``serve`` Workload adapters against the JAX
package's.

``cost_for`` prices a step's counts at a chip's rates.  The counts
(FLOPs, HBM, ICI and DCN bytes, and every ``detail`` entry) must equal
the reference's; fed a chip table built from the reference's TPU v5e
constants (``repro.roofline.hw``, ``repro.power.model.TPU_*``) the
times must equal its times bit for bit, and so must the adapters' jobs.
The adapters' DVFS plans go through the planner, which
``tests/test_torch_energy.py`` holds at rel = 1e-12 (its throttle curve
sums in another order), so their traces are held at that tolerance.
"""
import dataclasses
import importlib

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.cluster.workload as JW  # noqa: E402
import repro.config as JCF  # noqa: E402
import repro.roofline.analytic as JA  # noqa: E402
import repro_torch.cluster.workload as TW  # noqa: E402
import repro_torch.config as TCF  # noqa: E402
import repro_torch.roofline.analytic as TA  # noqa: E402
from repro.power import model as JM  # noqa: E402
from repro.roofline import hw as jhw  # noqa: E402
from repro_torch.models.frontend import enc_len_for  # noqa: E402
from repro_torch.power import model as TM  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402

REL = 1e-12

# The JAX package's TPU chip and links as a table of the port.
TPU_TABLE = TM.ChipTable(
    name="TPU v5e (the JAX package's constants)",
    idle_w=JM.TPU_IDLE_W, dyn_compute_w=JM.TPU_DYN_COMPUTE_W,
    dyn_mem_w=JM.TPU_DYN_MEM_W, power_limit_w=JM.TPU_TDP_W,
    peak_f32_flops=jhw.PEAK_BF16_FLOPS, peak_bf16_flops=jhw.PEAK_BF16_FLOPS,
    hbm_bw=jhw.HBM_BW, link_bw=jhw.ICI_LINK_BW, dcn_bw=jhw.DCN_POD_BW)

MESHES = ["SINGLE_POD_MESH", "MULTI_POD_MESH"]


def _close(got, want, rel=REL):
    np.testing.assert_allclose(np.asarray(got, dtype=float),
                               np.asarray(want, dtype=float),
                               rtol=rel, atol=0.0)


def _cfgs(arch, smoke):
    t, j = TCF.get_arch(arch), JCF.get_arch(arch)
    return (t.smoke(), j.smoke()) if smoke else (t.full(), j.full())


def _same_cost(got, want):
    assert (got.flops, got.hbm_bytes, got.ici_bytes, got.dcn_bytes) == \
        (want.flops, want.hbm_bytes, want.ici_bytes, want.dcn_bytes)
    assert got.detail == want.detail
    assert (got.compute_s, got.memory_s, got.collective_s) == \
        (want.compute_s, want.memory_s, want.collective_s)


# -- configuration copies ----------------------------------------------------

@pytest.mark.parametrize("arch", JCF.ARCH_IDS)
def test_arch_configs_are_copies(arch):
    for smoke in (False, True):
        t, j = _cfgs(arch, smoke)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert (t.vocab_padded, t.d_inner_ssm, t.n_ssm_heads, t.attn_free) \
            == (j.vocab_padded, j.d_inner_ssm, j.n_ssm_heads, j.attn_free)
        assert enc_len_for(t, 4096) == max(1, 4096 // j.encoder_ratio)
        for name in JCF.SHAPES:
            assert TCF.shape_applicable(t, TCF.SHAPES[name]) == \
                JCF.shape_applicable(j, JCF.SHAPES[name])


def test_shape_mesh_and_train_configs_are_copies():
    assert TCF.ARCH_IDS == JCF.ARCH_IDS
    assert sorted(TCF._MODULE_FOR_ID) == sorted(JCF._MODULE_FOR_ID)
    assert {k: dataclasses.asdict(v) for k, v in TCF.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JCF.SHAPES.items()}
    assert TCF.all_cells() == JCF.all_cells()
    for name in MESHES:
        t, j = getattr(TCF, name), getattr(JCF, name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.n_devices, t.multi_pod, t.data_axes, t.data_size,
                t.model_size) == (j.n_devices, j.multi_pod, j.data_axes,
                                  j.data_size, j.model_size)
    assert dataclasses.asdict(TCF.TrainConfig()) == \
        dataclasses.asdict(JCF.TrainConfig())
    with pytest.raises(KeyError):
        TCF.get_arch("no-such-model")


def test_param_counts_of_the_published_configs():
    """The ten published widths, counted by the port's copy."""
    counts = {a: TCF.full_config(a).param_count() for a in TCF.ARCH_IDS}
    assert counts == {a: JCF.full_config(a).param_count()
                      for a in JCF.ARCH_IDS}
    assert counts["mamba2-370m"] == 368_126_976


# -- cost_for ----------------------------------------------------------------

@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("shape", list(JCF.SHAPES))
@pytest.mark.parametrize("arch", JCF.ARCH_IDS)
def test_cost_for_equals_the_reference(arch, shape, mesh):
    t, j = _cfgs(arch, smoke=False)
    got = TA.cost_for(t, TCF.SHAPES[shape], getattr(TCF, mesh),
                      chip=TPU_TABLE)
    want = JA.cost_for(j, JCF.SHAPES[shape], getattr(JCF, mesh))
    _same_cost(got, want)


VARIANTS = [
    ("train", dict(block_skip=True)),
    ("train", dict(tc=dict(remat="block", microbatches=4,
                           moment_dtype="bfloat16"))),
    ("train", dict(tc=dict(remat="none"))),
    ("prefill", dict(block_skip=True, serve_tp_only=False)),
    ("decode", dict(kv_int8=True)),
    ("decode", dict(moe_ep=True)),
    ("decode", dict(replicas=4)),
    ("decode", dict(serve_tp_only=False, replicas=2)),
]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("kind,kw", VARIANTS,
                         ids=[f"{k}-{'-'.join(kw)}" for k, kw in VARIANTS])
@pytest.mark.parametrize("arch", ["llama3-8b", "deepseek-v2-236b",
                                  "grok-1-314b", "whisper-small",
                                  "hymba-1.5b", "mamba2-370m"])
def test_cost_for_options_equal_the_reference(arch, kind, kw, smoke):
    t, j = _cfgs(arch, smoke)
    kw = dict(kw)
    tc = kw.pop("tc", None)
    shape = (2048, 16, kind)
    got = TA.cost_for(t, TCF.ShapeConfig("x", *shape), TCF.MULTI_POD_MESH,
                      None if tc is None else TCF.TrainConfig(**tc),
                      chip=TPU_TABLE, **kw)
    want = JA.cost_for(j, JCF.ShapeConfig("x", *shape), JCF.MULTI_POD_MESH,
                       None if tc is None else JCF.TrainConfig(**tc), **kw)
    _same_cost(got, want)


def test_cost_for_prices_at_the_h100_by_default():
    cfg = TCF.full_config("llama3-8b")
    ac = TA.cost_for(cfg, TCF.SHAPES["train_4k"], TCF.MULTI_POD_MESH)
    assert ac.chip is TM.H100_SXM
    assert ac.compute_s == ac.flops / hw.PEAK_BF16_FLOPS
    assert ac.memory_s == ac.hbm_bytes / hw.HBM_BW
    assert ac.collective_s == ac.ici_bytes / hw.NVLINK_BW \
        + ac.dcn_bytes / hw.DCN_BW
    assert ac.dcn_bytes > 0.0
    assert (hw.NVLINK_BW, hw.DCN_BW) == (450e9, 50e9)
    assert TA.layer_param_bytes(cfg) == \
        JA.layer_param_bytes(JCF.full_config("llama3-8b"))


# -- the train and serve adapters --------------------------------------------

def _trace_close(got, want):
    assert np.array_equal(got.t, want.t)
    assert sorted(got.components) == sorted(want.components)
    for k in got.components:
        _close(got.components[k], want.components[k])
    _close(got.flops_rate, want.flops_rate)
    assert sorted(got.aux) == sorted(want.aux)
    for k in got.aux:
        _close(got.aux[k], want.aux[k])


ADAPTERS = [
    ("train", dict()),
    ("train", dict(arch="mamba2-370m", steps=3, batch=4, seq=256,
                   remat="layer")),
    ("train", dict(arch="deepseek-v2-236b", smoke=False, steps=2)),
    ("serve", dict()),
    ("serve", dict(arch="mamba2-370m", batch=8, prompt_len=512, gen=16)),
    ("serve", dict(arch="qwen1.5-32b", smoke=False, kv_int8=True)),
    ("serve", dict(arch="hymba-1.5b", smoke=False, gen=64)),
]


@pytest.mark.parametrize("op_kw", [None, dict(f_mhz=900.0),
                                   dict(f_mhz=520.0, vid=1.1425)])
@pytest.mark.parametrize("kind,kw", ADAPTERS)
def test_adapters_equal_the_reference_under_its_constants(kind, kw, op_kw):
    got = TW.make_workload(kind, chip=TPU_TABLE, **kw)
    want = JW.make_workload(kind, **kw)
    a, b = got.job(), want.job()
    assert (a.name, a.kind, a.shardable, a.mem_gb, a.work_units,
            a.state_bytes) == (b.name, b.kind, b.shardable, b.mem_gb,
                               b.work_units, b.state_bytes)
    assert got.state_bytes() == want.state_bytes()
    tops = TM.OperatingPoint() if op_kw is None else TM.OperatingPoint(**op_kw)
    jops = JM.OperatingPoint() if op_kw is None else JM.OperatingPoint(**op_kw)
    tplan, jplan = got.energy_plan(op=tops)[0], want.energy_plan(op=jops)[0]
    assert (tplan.freq_scale, tplan.dominant, tplan.throttled) == \
        (jplan.freq_scale, jplan.dominant, jplan.throttled)
    r, s = got.execute(tops), want.execute(jops)
    assert (r.name, r.kind) == (s.name, s.kind)
    _close([r.perf_gflops, r.wall_s, r.energy_j],
           [s.perf_gflops, s.wall_s, s.energy_j])
    assert r.details.keys() == s.details.keys()
    _trace_close(r.power_trace, s.power_trace)


def test_adapters_price_at_the_h100_by_default():
    for kind in ("train", "serve"):
        wl = TW.make_workload(kind)
        assert wl.chip is TM.H100_SXM
        plan = wl.energy_plan()[0]
        assert TM.H100_SXM.idle_w <= plan.power_w <= TM.H100_SXM.power_limit_w
        res = wl.execute(TM.OperatingPoint.green500())
        assert res.energy_j > 0.0 and res.perf_gflops > 0.0


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_adapter_on_a_shared_bus_equals_the_reference(kind):
    from repro.power.trace import TraceRecorder as JRecorder
    from repro_torch.power.trace import TraceRecorder
    res = []
    for rec, wl, op in ((TraceRecorder(source="t"),
                         TW.make_workload(kind, chip=TPU_TABLE),
                         TM.OperatingPoint()),
                        (JRecorder(source="t"), JW.make_workload(kind),
                         JM.OperatingPoint())):
        rec.emit(0.0, {"chip": 100.0}, flops_rate=0.0)
        rec.emit(2.0, {"chip": 100.0}, flops_rate=0.0)
        res.append(wl.execute(op, recorder=rec))
    got, want = res
    assert got.power_trace.t[0] == 0.0
    _close([got.energy_j, got.wall_s], [want.energy_j, want.wall_s])
    _trace_close(got.power_trace, want.power_trace)


def test_registry_kinds_equal_the_reference():
    import repro.serve  # noqa: F401  (registers serve_replay)
    import repro_torch.serve  # noqa: F401
    assert TW.list_workloads() == JW.list_workloads()
    assert TW._LAZY_KINDS == {"serve_replay": "repro_torch.serve.replay"}
    assert not hasattr(TW, "_UNPORTED_KINDS")
    assert importlib.import_module("repro_torch.serve.replay") \
        .ReplayServeWorkload is TW.WORKLOAD_REGISTRY["serve_replay"]
