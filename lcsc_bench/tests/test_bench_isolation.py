"""The run's process holds neither JAX nor the JAX package, compared by
whole top-level names; the reference imports nothing of the program; a
run without a CUDA device, or without the program beside it, fails and
prints no result."""
import ast
import json
import shutil
import subprocess
import sys

import pytest

from lcsc_bench.lib import spec
from lcsc_bench.lib.isolation import forbidden_modules


def test_top_level_name_compared_whole():
    names = ["repro_torch", "repro_torch.lqcd", "reprox", "jaxtyping",
             "torch", "flaxen"]
    assert forbidden_modules(names) == []
    assert forbidden_modules(names + ["repro.hpl", "jax.numpy", "flax",
                                      "jaxlib"]) == \
        ["flax", "jax.numpy", "jaxlib", "repro.hpl"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((spec.BENCH_DIR / "reference")
                                        .glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("path", sorted(spec.BENCH_DIR.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(spec.BENCH_DIR)))
def test_no_source_imports_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"repro", "jax", "jaxlib", "flax"}


def _run(root):
    return subprocess.run(
        [sys.executable, "lcsc_bench/run.py", "--workload",
         "lqcd-thermal-solve", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=root, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def _printed_result(proc):
    for line in proc.stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return True
        except (ValueError, TypeError):
            pass
    return False


def test_a_run_without_a_card_fails():
    proc = _run(spec.ROOT)
    assert proc.returncode != 0
    assert not _printed_result(proc)


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "lcsc_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert not _printed_result(proc)
