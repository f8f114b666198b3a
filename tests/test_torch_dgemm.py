"""The port's GEMM kernel module on the CPU: the plain version against the
JAX package's Pallas ``dgemm`` (run as the JAX tests run it off-TPU, in
interpret mode), the in-place update on strided views, CPU dispatch of
the ops wrapper, and the CUDA wrappers' refusal of what the kernel cannot
take.  The kernel itself runs in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.dgemm import dgemm as jax_dgemm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.dgemm import kernel as K  # noqa: E402
from repro_torch.kernels.dgemm import ops, ref  # noqa: E402

SHAPES = [(128, 128, 128), (256, 128, 384), (512, 256, 128)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# tests/test_kernels.py::test_dgemm_sweep
TOL = {"float32": dict(rtol=2e-5, atol=1e-3),
       "bfloat16": dict(rtol=0.1, atol=0.1)}


def _operands(m, n, k, dtype):
    rng = np.random.default_rng(m + n + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((k, n)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    # both frameworks round float32 to bfloat16 to nearest even
    return (torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt),
            jnp.asarray(x, jdt), jnp.asarray(y, jdt))


@pytest.mark.parametrize("m,n,k", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dgemm_matches_pallas(m, n, k, dtype):
    tx, ty, jx, jy = _operands(m, n, k, dtype)
    before = dict(K.LAUNCHES)
    got = ops.dgemm(tx, ty, bm=128, bn=128, bk=128)
    assert K.LAUNCHES == before          # the CPU takes the plain version
    assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
    want = jax_dgemm(jx, jy, bm=128, bn=128, bk=128)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("tiles", [{}, dict(bm=64, bn=128, bk=32),
                                   dict(bm=512, bn=512, bk=512)])
def test_tiles_do_not_change_the_result(tiles):
    tx, ty, _, _ = _operands(512, 256, 128, "float32")
    assert torch.equal(ops.dgemm(tx, ty, **tiles), ref.dgemm_ref(tx, ty))


@pytest.mark.parametrize("tiles", [dict(bm=96), dict(bn=100), dict(bk=80)])
def test_tiles_must_divide(tiles):
    tx, ty, _, _ = _operands(256, 128, 384, "float32")
    with pytest.raises(ValueError, match="must tile"):
        ops.dgemm(tx, ty, **tiles)


def test_tuned_raises(tmp_path):
    """``tuned=True`` (which raised before the port had an autotuner)
    resolves the tiles through the cache on the CPU, keyed ``torch-cpu``,
    and gives the plain version's result."""
    from repro_torch.autotune import TuneCache, set_default_cache
    tx, ty, _, _ = _operands(128, 128, 128, "float32")
    cache = TuneCache(tmp_path / "k.json")
    set_default_cache(cache)
    try:
        assert torch.equal(ops.dgemm(tx, ty, tuned=True),
                           ref.dgemm_ref(tx, ty))
        entry = cache.get("dgemm", (128, 128, 128), "torch-cpu")
    finally:
        set_default_cache(None)
    assert entry is not None and entry.config["bm"] in (64, 128)


def test_ref_out_dtype():
    tx, ty, _, _ = _operands(128, 128, 128, "bfloat16")
    got = ref.dgemm_ref(tx, ty, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               tx.float().numpy() @ ty.float().numpy(),
                               rtol=2e-5, atol=1e-3)


@pytest.mark.parametrize("lookahead", [0, 1])
@pytest.mark.parametrize("k0", [16, 17, 19])
def test_update_ref_on_strided_views(k0, lookahead):
    """HPL's trailing update on views of one matrix (row stride n): only
    the trailing window changes, by the product of the two panels."""
    n, nb = 96, 16
    a = np.random.default_rng(k0).standard_normal((n, n)).astype(np.float32)
    t = torch.from_numpy(a.copy())
    k1 = k0 + nb
    l21, u12, a22 = t[k1:, k0:k1], t[k0:k1, k1:], t[k1:, k1:]
    if lookahead:
        ops.dgemm_update_(a22[:, :nb], l21, u12[:, :nb])
        ops.dgemm_update_(a22[:, nb:], l21, u12[:, nb:])
    else:
        assert ops.dgemm_update_(a22, l21, u12) is a22
    want = a.copy()
    want[k1:, k1:] -= a[k1:, k0:k1] @ a[k0:k1, k1:]
    np.testing.assert_allclose(t.numpy(), want, rtol=2e-5, atol=1e-4)
    assert np.array_equal(t.numpy()[:k1], a[:k1])
    assert np.array_equal(t.numpy()[:, :k1], a[:, :k1])


def test_update_ref_rounds_once_to_bf16():
    rng = np.random.default_rng(3)
    c, x, y = (rng.standard_normal(s).astype(np.float32)
               for s in ((32, 48), (32, 24), (24, 48)))
    tc = torch.from_numpy(c).bfloat16()
    want = (tc.float() - torch.from_numpy(x) @ torch.from_numpy(y)).bfloat16()
    got = ref.dgemm_update_ref_(tc, torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything tries to build or load the library."""
    def refuse(*args, **kwargs):
        raise AssertionError("the library must not be built or loaded")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(K, "_lib", refuse)


def _cpu_call(which):
    x, y = torch.ones(4, 8), torch.ones(8, 4)
    if which == "dgemm":
        return K.dgemm(x, y)
    return K.dgemm_update_(torch.ones(4, 4), x, y)


@pytest.mark.parametrize("which", ["dgemm", "dgemm_update_"])
def test_cuda_wrappers_refuse_cpu_tensors_without_building(no_build, which):
    with pytest.raises(ValueError, match="CUDA device"):
        _cpu_call(which)


@pytest.mark.parametrize("bad, err, match", [
    (lambda: K.dgemm(torch.ones(4, 8), torch.ones(7, 4)), ValueError,
     "inner dimensions"),
    (lambda: K.dgemm(torch.ones(4, 8, dtype=torch.float64),
                     torch.ones(8, 4, dtype=torch.float64)), TypeError,
     "float32 or bfloat16"),
    (lambda: K.dgemm(torch.ones(4, 8), torch.ones(8, 4).bfloat16()),
     TypeError, "share a dtype"),
    (lambda: K.dgemm(torch.ones(8, 4).t(), torch.ones(8, 4)), ValueError,
     "row-major"),
    (lambda: K.dgemm(torch.ones(4, 8), torch.ones(8, 4), torch.float16),
     TypeError, "out_dtype"),
    (lambda: K.dgemm(torch.ones(4), torch.ones(4, 4)), ValueError, "2-D"),
    (lambda: K.dgemm_update_(torch.ones(4, 5), torch.ones(4, 8),
                             torch.ones(8, 4)), ValueError, "c must have"),
])
def test_cuda_wrappers_check_before_building(no_build, bad, err, match):
    with pytest.raises(err, match=match):
        bad()
