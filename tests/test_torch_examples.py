"""The port's five examples (``examples/torch_*.py``) run on the CPU and
print what their JAX counterparts print.

Each example's ``main`` runs with ``--device cpu``; its key lines are
checked: the D-slash kernels' difference from their plain versions and
the solves' residuals (<= 1e-6) in ``lqcd_cg``, a falling loss and eight
tokens in ``quickstart``, the Green500 walk-through's lines equal to the
JAX example's, the paper's operating point in ``autotune_sweep``, the
int8 cache's size and the memory-bound plan in ``efficient_serving``.
"""
import importlib.util
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_quickstart(capsys):
    out = _load("torch_quickstart").main(["--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 40 and all(map(math.isfinite, losses))
    assert losses[-1] < losses[0] - 1.0
    assert len(out["tokens"]) == 8
    text = capsys.readouterr().out
    assert "training llama3-8b-smoke on cpu" in text
    assert "  step  39  loss" in text and "generated: [" in text


def test_lqcd_cg(capsys):
    out = _load("torch_lqcd_cg").main(["--device", "cpu"])
    assert out["err_full"] <= 1e-6 and out["err_eo"] <= 1e-6
    assert out["plain"].converged and out["plain"].rel_residual <= 1e-6
    assert out["eo"].converged and out["eo"].rel_residual <= 1e-6
    # the even-odd mixed solve needs fewer normal ops than the plain one
    assert out["eo"].iters < out["plain"].iters
    assert out["plan"].dominant == "memory"
    text = capsys.readouterr().out
    assert "GFLOPS on CPU" in text
    assert "energy-to-solution (NVIDIA H100 SXM table, modelled)" in text
    assert "(H100 table, modelled)" in text


def test_green500_measurement_prints_the_jax_examples_lines(capsys,
                                                            monkeypatch):
    out = _load("torch_green500_measurement").main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(sys, "argv", ["green500_measurement.py"])
    _load("green500_measurement").main()
    want = capsys.readouterr().out.splitlines()
    # the walk-through is the JAX example's, line for line; the port adds
    # its device's smoke Linpack
    assert got[:len(want)] == want
    assert got[-1].startswith("cpu Linpack n=192") and "modelled" in got[-1]
    assert out["hpl"].passed
    assert out["exploit"] > out["levels"][3]


def test_autotune_sweep(capsys, tmp_path):
    from repro_torch.autotune import set_default_cache
    try:
        out = _load("torch_autotune_sweep").main(
            ["--device", "cpu", str(tmp_path / "c.json")])
    finally:
        set_default_cache(None)
    best = out["best"]
    assert (best["f_mhz"], best["vid"], best["fan"]) == (774.0, 1.1425, 0.4)
    assert out["coordinate_same"]
    assert set(out["dgemm"]) == {"bm", "bn", "bk"}
    text = capsys.readouterr().out
    assert "coordinate descent: same point = True" in text
    assert "cache persisted:" in text and (tmp_path / "c.json").exists()


def test_efficient_serving(capsys):
    out = _load("torch_efficient_serving").main(["--device", "cpu"])
    bf16, int8 = out["runs"][False], out["runs"][True]
    assert int8["cache_mib"] < bf16["cache_mib"]
    assert bf16["tokens"].shape == int8["tokens"].shape == (4, 16)
    assert out["plan"].dominant == "memory"
    text = capsys.readouterr().out
    assert "kv_int8=True" in text and "(NVIDIA H100 SXM, modelled)" in text


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_lqcd_cg",
                                  "torch_green500_measurement",
                                  "torch_autotune_sweep",
                                  "torch_efficient_serving"])
def test_examples_refuse_the_cpu_without_being_asked(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _load(name).main([])
