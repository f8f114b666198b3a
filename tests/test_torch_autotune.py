"""The port's autotuner on the CPU against the JAX package's
``repro.autotune``: the spaces, both searchers (best point, evaluations and
trace, under the same toy cost models and the reference's perf-floor
cases), the operating-point and HPL-blocking searches (exactly equal, the
Green500 point among them), the node power of the measured HPL model, the
cache file either package reads, the ``tuned=True`` paths, and the H100
cost models of the CUDA kernels.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:               # deterministic grid fallback
    from _hypothesis_fallback import given, settings, strategies as st

import jax.numpy as jnp  # noqa: E402

import repro.autotune as J  # noqa: E402
import repro_torch.autotune as T  # noqa: E402
from repro.autotune import space as JS  # noqa: E402
from repro_torch.autotune import measure as TM  # noqa: E402
from repro_torch.autotune import space as TS  # noqa: E402
from repro_torch.kernels.dgemm import kernel as GK  # noqa: E402
from repro_torch.roofline import hw  # noqa: E402

REL = 1e-12
GREEN500 = {"f_mhz": 774.0, "vid": 1.1425, "fan": 0.40, "nb": 512,
            "lookahead": 1}


@pytest.fixture
def fresh_caches():
    """Both packages' default caches, empty and in memory."""
    T.set_default_cache(T.TuneCache())
    J.set_default_cache(J.TuneCache())
    yield
    T.set_default_cache(None)
    J.set_default_cache(None)


def _same_result(got, want):
    """Two TuneResults equal field for field, trace included."""
    def cand(c):
        return (c.point, c.perf_gflops, c.power_w)
    assert cand(got.best) == cand(want.best)
    assert (got.peak_perf_gflops, got.perf_floor_gflops, got.max_perf_loss,
            got.evaluations) == (want.peak_perf_gflops,
                                 want.perf_floor_gflops, want.max_perf_loss,
                                 want.evaluations)
    assert [cand(c) for c in got.trace] == [cand(c) for c in want.trace]


# -- spaces ------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    {}, dict(freqs_mhz=(774.0, 900.0)), dict(fans=(0.3, 0.4), lookaheads=(1,)),
    dict(vids=(1.15,), hpl_blocks=(256, 512, 1024))])
def test_operating_space_equals_the_reference(kwargs):
    got, want = TS.operating_space(**kwargs), JS.operating_space(**kwargs)
    assert got.axes == want.axes and got.size == want.size
    assert list(got.points()) == list(want.points())
    assert TS.S9150_DPM_STATES_MHZ == JS.S9150_DPM_STATES_MHZ


def test_space_helpers_equal_the_reference():
    axes = {"x": (1, 2, 3), "y": ("a", "b")}
    got, want = TS.Space(dict(axes)), JS.Space(dict(axes))
    assert got.first() == want.first() and got.names == want.names
    assert list(got.neighbors({"x": 2, "y": "b"}, "x")) == \
        list(want.neighbors({"x": 2, "y": "b"}, "x"))
    assert got.with_axis("y", ("c",)).axes == want.with_axis("y", ("c",)).axes
    for mod in (TS, JS):
        with pytest.raises(ValueError, match="no candidate"):
            mod.Space({"x": ()})


@pytest.mark.parametrize("shape, want", [
    ((32512, 256, 32256), {"bm": (64, 128), "bn": (128,), "bk": (16,)}),
    ((1024, 256, 1024), {"bm": (64, 128), "bn": (128,), "bk": (16,)}),
    ((96, 8, 200), {"bm": (96,), "bn": (200,), "bk": (8,)}),
    ((192, 48, 64), {"bm": (64,), "bn": (64,), "bk": (16,)}),
])
def test_dgemm_tile_space_is_the_kernels(shape, want):
    assert T.dgemm_tile_space(*shape).axes == want
    assert GK.TILES == ((128, 128, 16), (64, 128, 16))


@pytest.mark.parametrize("lat", [(32, 32, 32, 8), (8, 8, 8, 16), (4, 4, 4, 1)])
def test_dslash_space_is_one_launch(lat):
    space = T.dslash_tile_space(lat)
    assert list(space.points()) == [{"threads": 128}]
    res = T.tune_dslash_tblock(lat)
    assert res.best.point == {"threads": 128} and res.evaluations == 1


# -- searchers ---------------------------------------------------------------

def _toy_space(mod):
    return mod.Space({"x": tuple(range(1, 8)), "y": tuple(range(1, 6))})


def _toy_model(a, b):
    def ev(p):
        if p["x"] == a and p["y"] == min(b, 5):     # infeasible hole
            return 0.0, float("inf")
        perf = 10.0 * p["x"] + a * p["y"]
        power = 5.0 + (p["x"] - 3) ** 2 + b * p["y"]
        return perf, power
    return ev


@settings(max_examples=12, deadline=None)
@given(loss=st.floats(0.0, 0.45), a=st.integers(1, 7), b=st.integers(1, 5))
def test_searchers_equal_the_reference(loss, a, b):
    """tests/test_autotune.py's perf-floor property, both packages on one
    toy model: identical results, and the floor held."""
    ev = _toy_model(a, b)
    for name in ("grid_search", "coordinate_descent"):
        got = getattr(T, name)(_toy_space(T), ev, max_perf_loss=loss)
        want = getattr(J, name)(_toy_space(J), ev, max_perf_loss=loss)
        _same_result(got, want)
        assert got.best.perf_gflops >= got.perf_floor_gflops - 1e-9
        assert got.perf_floor_gflops == pytest.approx(
            (1.0 - loss) * got.peak_perf_gflops)
        assert got.perf_loss == want.perf_loss
        assert got.as_config() == want.as_config()


@pytest.mark.parametrize("start", [None, {"x": 7, "y": 5}, {"x": 3, "y": 1}])
@pytest.mark.parametrize("rounds", [1, 8])
def test_coordinate_descent_start_and_rounds(start, rounds):
    ev = _toy_model(4, 2)
    got = T.coordinate_descent(_toy_space(T), ev, max_perf_loss=0.2,
                               start=start, max_rounds=rounds)
    want = J.coordinate_descent(_toy_space(J), ev, max_perf_loss=0.2,
                                start=start, max_rounds=rounds)
    _same_result(got, want)


def test_grid_search_skips_infeasible_and_is_deterministic():
    def ev(p):
        if p["x"] == 2:
            return 0.0, float("inf")
        return 10.0, 10.0 / p["x"]         # x=3 most efficient

    got = T.grid_search(T.Space({"x": (1, 2, 3)}), ev, max_perf_loss=0.5)
    want = J.grid_search(J.Space({"x": (1, 2, 3)}), ev, max_perf_loss=0.5)
    _same_result(got, want)
    assert got.best.point == {"x": 3} and got.evaluations == 3
    assert T.grid_search(T.Space({"x": (1, 2)}), ev,
                         keep_trace=False).trace == []


def test_nothing_feasible_raises():
    for mod in (T, J):
        with pytest.raises(ValueError, match="no feasible"):
            mod.grid_search(mod.Space({"x": (1, 2)}),
                            lambda p: (0.0, float("inf")))


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown search method"):
        T.tune_operating_point(method="anneal")


# -- the paper's operating point and HPL blocking ----------------------------

@pytest.mark.parametrize("method", ["grid", "coordinate"])
def test_operating_point_equals_the_reference(method):
    got = T.tune_operating_point(method=method)
    want = J.tune_operating_point(method=method)
    assert got.best.point == want.best.point == GREEN500
    assert got.evaluations == want.evaluations
    assert got.best.mflops_per_w == pytest.approx(want.best.mflops_per_w,
                                                  rel=REL)
    assert got.best.mflops_per_w == pytest.approx(5211.9, abs=0.05)
    assert got.perf_loss == pytest.approx(want.perf_loss, rel=REL)
    if method == "grid":
        assert got.evaluations == 1904


def test_recommended_operating_point_is_green500_and_cached():
    from repro_torch.power.model import OperatingPoint
    op = TM.recommended_operating_point()
    assert op == OperatingPoint.green500()
    assert op == OperatingPoint.from_point(GREEN500)
    assert TM.recommended_operating_point() is op


@pytest.mark.parametrize("n", [192, 1024, 4096, 32768])
@pytest.mark.parametrize("method", ["grid", "coordinate"])
def test_hpl_blocking_equals_the_reference(n, method):
    got = T.tune_hpl_blocking(n, method=method)
    want = J.tune_hpl_blocking(n, method=method)
    assert got.best.point == want.best.point
    assert got.evaluations == want.evaluations
    assert got.best.mflops_per_w == pytest.approx(want.best.mflops_per_w,
                                                  rel=REL)
    for g, w in zip(got.trace, want.trace):
        assert g.point == w.point
        assert g.perf_gflops == pytest.approx(w.perf_gflops, rel=REL)
        assert g.power_w == pytest.approx(w.power_w, rel=REL)
    # the analytic model maps blocks by their fraction of n: n / 4 wins
    assert got.best.point == {"block": n // 4, "lookahead": 1}


@pytest.mark.parametrize("point", [{"block": 48, "lookahead": 1},
                                   {"block": 96, "lookahead": 2},
                                   {"block": 32, "lookahead": 0}])
def test_measured_hpl_power_equals_the_reference(point):
    """The measured HPL model's node power at a point (the runs
    themselves are the port's LU on the CPU) is the reference's; its
    performance is the fastest of its ``reps`` runs."""
    model = T.MeasuredHPLModel(n=192, device="cpu")
    perf, power = model.evaluate(point)
    j_perf, j_power = J.MeasuredHPLModel(n=192).evaluate(point)
    assert power == pytest.approx(j_power, rel=REL)
    assert perf > 0 and j_perf > 0
    assert len(model.runs) == model.reps == 3
    for p, res in model.runs:
        assert p == point and res.passed and res.block == point["block"]
    assert perf == max(res.gflops for _, res in model.runs)
    assert model.evaluate({"block": 100}) == TM.INFEASIBLE


def test_analytic_hpl_model_equals_the_reference():
    for n, block, la in ((192, 48, 1), (4096, 1024, 2), (4096, 333, 1)):
        point = {"block": block, "lookahead": la}
        got = T.AnalyticHPLBlockingModel(n).evaluate(point)
        want = J.AnalyticHPLBlockingModel(n).evaluate(point)
        assert got == pytest.approx(want, rel=REL)


# -- the cache ---------------------------------------------------------------

def test_each_package_reads_the_others_cache(tmp_path):
    t_path, j_path = tmp_path / "t.json", tmp_path / "j.json"
    t_cache, j_cache = T.TuneCache(t_path), J.TuneCache(j_path)
    T.tuned_config("hpl", (1024,), device="cpu", cache=t_cache)
    T.tuned_config("dgemm", (1024, 256, 1024), device="cpu", cache=t_cache)
    J.tuned_config("hpl", (1024,), device="cpu", cache=j_cache)
    J.tuned_config("dgemm", (1024, 1024, 1024), device="cpu", cache=j_cache)
    assert json.loads(t_path.read_text())["version"] == \
        json.loads(j_path.read_text())["version"] == 1
    t_read, j_read = T.TuneCache(j_path), J.TuneCache(t_path)
    assert t_read.to_dict() == j_cache.to_dict()
    assert j_read.to_dict() == t_cache.to_dict()
    assert t_read.get("hpl", (1024,), "cpu").config == \
        j_read.get("hpl", (1024,), "torch-cpu").config
    # one file holding both: the port's keys never equal the reference's
    both = T.TuneCache(tmp_path / "both.json")
    both.load(t_path).load(j_path)
    assert len(both) == len(t_cache) + len(j_cache)
    assert not set(t_cache.keys()) & set(j_cache.keys())
    assert all(k.endswith("|torch-cpu") for k in t_cache.keys())


def test_cache_env_var_and_version(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "e.json"))
    T.set_default_cache(None)
    try:
        assert T.default_cache().path == tmp_path / "e.json"
    finally:
        T.set_default_cache(None)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 99, "entries": {}}))
    with pytest.raises(ValueError, match="unsupported cache version"):
        T.TuneCache(bad)


def test_tuned_config_memoizes(tmp_path):
    cache = T.TuneCache(tmp_path / "c.json")
    got = T.tuned_config("hpl", (256,), device="cpu", cache=cache)
    assert got == J.tuned_config("hpl", (256,), device="cpu",
                                 cache=J.TuneCache())
    before = (tmp_path / "c.json").read_text()
    assert T.tuned_config("hpl", (256,), device="cpu", cache=cache) == got
    assert (tmp_path / "c.json").read_text() == before
    op = T.tuned_config("operating_point", (), device="cpu", cache=cache)
    assert op == GREEN500
    with pytest.raises(KeyError, match="unknown tunable"):
        T.tuned_config("attention", (1,), device="cpu", cache=cache)


def test_device_keys():
    assert T._device_name("cpu") == "torch-cpu"
    assert T._device_name(torch.device("cpu")) == "torch-cpu"


def test_tuned_config_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.tuned_config("hpl", (256,), cache=T.TuneCache())


# -- the tuned=True paths ----------------------------------------------------

def test_linpack_tuned_path(fresh_caches):
    from repro.configs.hpl import HPLConfig as JHPLConfig
    from repro.hpl import linpack_run as jax_linpack_run
    from repro_torch.configs.hpl import HPLConfig
    from repro_torch.hpl import linpack_run
    r = linpack_run(HPLConfig(n=192, block=96, mode="efficiency"),
                    tuned=True, device="cpu")
    want = jax_linpack_run(JHPLConfig(n=192, block=96, mode="efficiency"),
                           tuned=True)
    assert r.passed and r.mode == "efficiency"
    assert 192 % r.block == 0 and r.block < 96
    assert (r.block, r.mode) == (want.block, want.mode)
    assert T.default_cache().get("hpl", (192,), "torch-cpu") is not None


def test_dgemm_tuned_path_matches_the_reference(fresh_caches):
    from repro.kernels.dgemm import dgemm as jax_dgemm
    from repro_torch.kernels.dgemm import dgemm
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 256)).astype(np.float32)
    y = rng.standard_normal((256, 256)).astype(np.float32)
    got = dgemm(torch.from_numpy(x), torch.from_numpy(y), tuned=True)
    want = jax_dgemm(jnp.asarray(x), jnp.asarray(y), tuned=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    entry = T.default_cache().get("dgemm", (256, 256, 256), "torch-cpu")
    assert entry.config == {"bm": 64, "bn": 128, "bk": 16}
    assert entry.model == "analytic"


def test_dgemm_explicit_tiles_win_over_the_cache(fresh_caches):
    from repro_torch.kernels.dgemm import dgemm
    x, y = torch.ones(96, 32), torch.ones(32, 64)
    with pytest.raises(ValueError, match="must tile"):
        dgemm(x, y, bm=64, tuned=True)       # 96 % 64: the caller's tile
    assert torch.equal(dgemm(x, y, tuned=True), x @ y)
    assert T.default_cache().get("dgemm", (96, 32, 64),
                                 "torch-cpu").config == \
        {"bm": 96, "bn": 64, "bk": 16}


# -- the H100 cost models ----------------------------------------------------

@pytest.mark.parametrize("shape, bm", [((32512, 256, 32256), 128),
                                       ((1024, 256, 1024), 64)])
def test_dgemm_model_picks(shape, bm):
    res = T.tune_dgemm_tiles(*shape)
    assert res.best.point == {"bm": bm, "bn": 128, "bk": 16}
    assert res.evaluations == 2
    assert res.best.point == T.tune_dgemm_tiles(
        *shape, method="coordinate").best.point


def test_dgemm_model_on_the_data_sheet():
    # step 0's update at n = 32768: 254 x 252 tiles over 132 SMs, the
    # busiest doing 485, compute-bound at the f32 peak
    m, k, n = 32512, 256, 32256
    perf, power = T.AnalyticDgemmModel(m, k, n).evaluate(
        {"bm": 128, "bn": 128, "bk": 16})
    fill = 485 * 132 / (254 * 252)
    assert perf == pytest.approx(hw.PEAK_F32_FLOPS / fill / 1e9, rel=REL)
    assert 120.39 < power
    # (1024, 256) @ (256, 1024): the 128-row tile's 64 tiles leave 68 of
    # the 132 SMs idle (compute-bound at 64/132 of the peak); the 64-row
    # tile's 128 leave 4, and it is then bound by y re-read for each of
    # its 16 rows of tiles
    small = T.AnalyticDgemmModel(1024, 256, 1024)
    perf128, _ = small.evaluate({"bm": 128, "bn": 128, "bk": 16})
    perf64, _ = small.evaluate({"bm": 64, "bn": 128, "bk": 16})
    assert perf128 == pytest.approx(hw.PEAK_F32_FLOPS * 64 / 132 / 1e9,
                                    rel=REL)
    hbm = (1024 * 256 * 8 + 256 * 1024 * 16 + 1024 * 1024) * 4
    assert perf64 == pytest.approx(2 * 1024 * 256 * 1024 * hw.HBM_BW / hbm
                                   / 1e9, rel=REL)
    # a tile that does not divide its dimension is infeasible
    assert T.AnalyticDgemmModel(512, 512, 512).evaluate(
        {"bm": 96, "bn": 128, "bk": 16}) == TM.INFEASIBLE


def test_measured_dgemm_model_on_the_cpu():
    model = T.MeasuredDgemmModel(64, 32, 128, reps=2, device="cpu")
    point = {"bm": 64, "bn": 128, "bk": 16}
    perf, power = model.evaluate(point)
    assert perf > 0
    assert power == T.AnalyticDgemmModel(64, 32, 128).evaluate(point)[1]
    assert model.evaluate({"bm": 48, "bn": 128, "bk": 16}) == TM.INFEASIBLE
    res = T.tune_dgemm_tiles(64, 32, 128, measured=True, device="cpu")
    assert res.best.point == point and res.evaluations == 1


def test_dslash_model_prices_b2_at_its_bound():
    """B2 at 32^3 x 8: 125.8 MB of compulsory bytes, 37.6 us at 3.35 TB/s
    (chip_smoke's bound for the full hop), within 1%."""
    model = T.AnalyticDslashModel((32, 32, 32, 8))
    assert model.hbm_bytes == pytest.approx(125.8e6, rel=1e-3)
    perf, power = model.evaluate({"threads": 128})
    seconds = 32 ** 3 * 8 * 1320 / (perf * 1e9)
    assert seconds == pytest.approx(37.6e-6, rel=0.01)
    assert 120.39 < power < 700.0
    assert model.evaluate({"threads": 256}) == TM.INFEASIBLE
