"""The port's RMSNorm kernel module on the CPU: the plain version against
the JAX package's Pallas ``rmsnorm`` (run as the JAX tests run it off-TPU,
in interpret mode) and its ``rmsnorm_ref``, CPU dispatch of the ops
wrapper, and the CUDA wrapper's refusal of what the kernel cannot take.
The kernel itself runs in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro_torch.kernels import _build, timing  # noqa: E402
from repro_torch.kernels.rmsnorm import bench  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as K  # noqa: E402
from repro_torch.kernels.rmsnorm import ops, ref  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# tests/test_kernels.py::test_rmsnorm_sweep
TOL = {"float32": 1e-5, "bfloat16": 0.05}


def _operands(shape, dtype, w_dtype=None):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    twd, jwd = DTYPES[w_dtype or dtype]
    # both frameworks round float32 to bfloat16 to nearest even
    return (torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(twd),
            jnp.asarray(x, jdt), jnp.asarray(w, jwd))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("rows,d", [(64, 128), (256, 512), (33 * 4, 256)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_matches_pallas(rows, d, dtype):
    tx, tw, jx, jw = _operands((rows, d), dtype)
    before = dict(K.LAUNCHES)
    got = ops.rmsnorm(tx, tw)
    assert K.LAUNCHES == before          # the CPU takes the plain version
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _close(got, jax_rmsnorm(jx, jw), dtype)
    _close(got, jax_rmsnorm_ref(jx, jw), dtype)


# the serve path's widths (mamba2-370m): norm1 and final_norm in bf16 over
# d_model 1024, the gated norm in f32 with a bf16 scale over d_inner 2048,
# at 16 prefill rows and at a decode step's 4 rows
@pytest.mark.parametrize("rows", [16, 4])
@pytest.mark.parametrize("d,dtype,w_dtype", [(1024, "bfloat16", "bfloat16"),
                                             (2048, "float32", "bfloat16")])
def test_rmsnorm_matches_pallas_at_the_path_widths(rows, d, dtype, w_dtype):
    tx, tw, jx, jw = _operands((rows, d), dtype, w_dtype)
    got = ops.rmsnorm(tx, tw)
    assert got.dtype == tx.dtype and got.shape == (rows, d)
    _close(got, jax_rmsnorm(jx, jw), dtype)
    _close(got, jax_rmsnorm_ref(jx, jw), dtype)


def test_bench_path_shapes_count_the_serve_runs_launches():
    """97 RMSNorms per forward, one prefill and 64 decode steps."""
    shapes = bench.path_shapes(1024, 2048, 48, 4, 2048, 64)
    assert sum(s[-1] for s in shapes.values()) == 97 * 65
    assert shapes["norm1"][:4] == (8192, 1024, torch.bfloat16,
                                   torch.bfloat16)
    assert shapes["gated_decode"][:4] == (4, 2048, torch.float32,
                                          torch.bfloat16)


def test_bench_cold_sets_exceed_twice_the_l2():
    l2 = 50 * 2 ** 20                      # an H100's
    for rows, d, dt, want in ((8192, 1024, torch.bfloat16, 8),
                              (8192, 2048, torch.float32, 3),
                              (4, 1024, torch.bfloat16, bench.MAX_SETS)):
        n = bench.cold_sets(rows, d, dt, l2)
        assert n == want
        if n < bench.MAX_SETS:
            assert (n - 1) * rows * d * dt.itemsize > 2 * l2


@pytest.mark.parametrize("rows,d,dt,want_us", [
    (8192, 1024, torch.bfloat16, 10.0169),      # norm1: 33.56 MB
    (8192, 2048, torch.float32, 40.0662),       # gated, bf16 w: 134.2 MB
    (4, 2048, torch.float32, 0.0208)])          # gated decode
def test_bench_bound_is_the_bytes_at_the_hbm_rate(rows, d, dt, want_us):
    """x and w read once, out written once, at 3.35 TB/s; RMSNorm's four
    flops per element never bound it."""
    x = torch.empty(rows, d, dtype=dt, device="meta")
    w = torch.empty(d, dtype=torch.bfloat16, device="meta")
    ms, by = timing.bound([x, w, x], rows * d, bench.FLOPS_PER_ELEMENT)
    assert by == "bytes"
    assert ms * 1e3 == pytest.approx(want_us, abs=1e-4)


def test_reset_launches_clears_the_counts_by_shape():
    K.SHAPE_LAUNCHES[8192, 1024, torch.bfloat16] += 3
    K.LAUNCHES["rmsnorm"] += 3
    K.reset_launches()
    assert K.LAUNCHES == {"rmsnorm": 0} and not K.SHAPE_LAUNCHES


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_3d_and_mixed_weight_dtype(dtype):
    """(..., d) inputs, and a weight in the other dtype (the gated norm's
    float32 input with a bfloat16 scale)."""
    other = "float32" if dtype == "bfloat16" else "bfloat16"
    tx, tw, jx, jw = _operands((3, 5, 64), dtype, other)
    got = ops.rmsnorm(tx, tw)
    assert got.shape == (3, 5, 64) and got.dtype == tx.dtype
    _close(got, jax_rmsnorm(jx, jw), dtype)


def test_rmsnorm_eps():
    tx, tw, jx, jw = _operands((8, 16), "float32")
    tx, jx = tx * 1e-3, jx * 1e-3           # eps matters at this scale
    _close(ops.rmsnorm(tx, tw, eps=1e-5), jax_rmsnorm(jx, jw, eps=1e-5),
           "float32")
    assert not torch.allclose(ops.rmsnorm(tx, tw, eps=1e-5),
                              ops.rmsnorm(tx, tw), rtol=1e-3)


def test_ref_is_float32_math_rounded_once():
    tx, tw, _, _ = _operands((4, 32), "bfloat16")
    xf = tx.float()
    want = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-6)
            * tw.float()).bfloat16()
    assert torch.equal(ref.rmsnorm_ref(tx, tw), want)


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything tries to build or load the library."""
    def refuse(*args, **kwargs):
        raise AssertionError("the library must not be built or loaded")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(K, "_lib", refuse)


def test_cuda_wrapper_refuses_cpu_tensors_without_building(no_build):
    with pytest.raises(ValueError, match="CUDA device"):
        K.rmsnorm(torch.ones(4, 8), torch.ones(8))


@pytest.mark.parametrize("bad, err, match", [
    (lambda: K.rmsnorm(torch.ones(2, 4, 8), torch.ones(8)), ValueError,
     "2-D"),
    (lambda: K.rmsnorm(torch.ones(4, 8), torch.ones(7)), ValueError,
     "shape"),
    (lambda: K.rmsnorm(torch.ones(4, 8, dtype=torch.float64),
                       torch.ones(8)), TypeError, "float32 or bfloat16"),
    (lambda: K.rmsnorm(torch.ones(4, 8), torch.ones(8).half()), TypeError,
     "float32 or bfloat16"),
    (lambda: K.rmsnorm(torch.ones(8, 4).t(), torch.ones(8)), ValueError,
     "row-major"),
    (lambda: K.rmsnorm(torch.ones(4, 8), torch.ones(16)[::2]), ValueError,
     "contiguous"),
])
def test_cuda_wrapper_checks_before_building(no_build, bad, err, match):
    with pytest.raises(err, match=match):
        bad()
