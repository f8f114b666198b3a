"""The port's SSD-chunk kernel module on the CPU: the plain version against
the JAX package's Pallas ``ssd_chunk`` (interpret mode off-TPU, as its own
tests run it) and its ``ssd_chunk_ref``, CPU dispatch of the ops wrapper,
and the CUDA wrapper's refusal of what the kernel cannot take.  The
kernel itself runs in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ssd_chunk import ssd_chunk as jax_ssd_chunk  # noqa: E402
from repro.kernels.ssd_chunk import ssd_chunk_ref as jax_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as K  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_kernels_extra.py
# test_ssd_chunk_sweep's shapes (B, Q, H, P, N), then the mamba2 smoke
# model's chunk (Q = 32, 8 heads of P = 16, N = 16)
SHAPES = [(2, 16, 3, 8, 4), (1, 32, 2, 16, 8), (3, 8, 4, 4, 16),
          (2, 32, 8, 16, 16)]


def _inputs(B, Q, H, P, N):
    rng = np.random.default_rng(Q + H)
    x = rng.standard_normal((B, Q, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, Q, H)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(H) * 0.3)).astype(np.float32)
    Bm = rng.standard_normal((B, Q, N)).astype(np.float32)
    Cm = rng.standard_normal((B, Q, N)).astype(np.float32)
    h = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return x, dt, A, Bm, Cm, h


def _run_both(arrays, dtype):
    """The port's ops on CPU tensors and the JAX package's kernel and
    reference; x, B and C in ``dtype``, the rest float32."""
    x, dt, A, Bm, Cm, h = arrays
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    t = [torch.from_numpy(a) for a in arrays]
    for i in (0, 3, 4):
        t[i] = t[i].to(tdt)
    j = [jnp.asarray(a) for a in arrays]
    for i in (0, 3, 4):
        j[i] = j[i].astype(jdt)
    before = dict(K.LAUNCHES)
    got = ops.ssd_chunk(*t)
    assert K.LAUNCHES == before          # the CPU takes the plain version
    return got, jax_ssd_chunk(*j), jax_ref(*j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Q,H,P,N", SHAPES)
def test_ssd_chunk_matches_pallas(B, Q, H, P, N, dtype):
    (y, hn), (jy, jh), (ry, rh) = _run_both(_inputs(B, Q, H, P, N), dtype)
    assert y.dtype == hn.dtype == torch.float32
    assert y.shape == (B, Q, H, P) and hn.shape == (B, H, P, N)
    for got, want in ((y, jy), (hn, jh), (y, ry), (hn, rh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ssd_chunk_on_strided_views():
    """The model passes x, B and C as views of one conv output and dt as
    a slice of the sequence: the result is that of contiguous copies."""
    x, dt, A, Bm, Cm, h = (torch.from_numpy(a)
                           for a in _inputs(2, 16, 3, 8, 4))
    big = torch.cat([x.reshape(2, 16, 24), Bm, Cm], -1)
    xv = big[..., :24].reshape(2, 16, 3, 8)
    dtv = torch.cat([dt, dt], 1)[:, 16:]
    got = ops.ssd_chunk(xv, dtv, A, big[..., 24:28], big[..., 28:], h)
    want = ops.ssd_chunk(x, dt, A, Bm, Cm, h)
    assert not xv.is_contiguous() and not dtv.is_contiguous()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture
def no_build(monkeypatch):
    """Fail the test if anything tries to build or load the library."""
    def refuse(*args, **kwargs):
        raise AssertionError("the library must not be built or loaded")
    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(K, "_lib", refuse)


def _args(B=2, Q=16, H=3, P=8, N=4, **over):
    args = dict(x=torch.ones(B, Q, H, P), dt=torch.ones(B, Q, H),
                A=torch.ones(H), B_mat=torch.ones(B, Q, N),
                C_mat=torch.ones(B, Q, N), h=torch.ones(B, H, P, N))
    args.update(over)
    return args


def test_cuda_wrapper_refuses_cpu_tensors_without_building(no_build):
    with pytest.raises(ValueError, match="CUDA device"):
        K.ssd_chunk(**_args())


@pytest.mark.parametrize("over, err, match", [
    (dict(x=torch.ones(2, 16, 24)), ValueError, "x must be"),
    (dict(dt=torch.ones(2, 16, 4)), ValueError, "dt must have shape"),
    (dict(A=torch.ones(4)), ValueError, "A must have shape"),
    (dict(C_mat=torch.ones(2, 16, 5)), ValueError, "C_mat must have shape"),
    (dict(h=torch.ones(2, 3, 8, 5)), ValueError, "h must have shape"),
    (dict(x=torch.ones(2, 16, 3, 8, dtype=torch.float64)), TypeError,
     "float32 or bfloat16"),
    (dict(B_mat=torch.ones(2, 16, 4).bfloat16()), TypeError, "share x's"),
    (dict(dt=torch.ones(2, 16, 3).bfloat16()), TypeError, "dt must be"),
    (dict(x=torch.ones(2, 16, 8, 3).transpose(2, 3)), ValueError,
     "unit stride"),
    (dict(h=torch.ones(2, 3, 4, 8).transpose(2, 3)), ValueError,
     "contiguous"),
])
def test_cuda_wrapper_checks_before_building(no_build, over, err, match):
    with pytest.raises(err, match=match):
        K.ssd_chunk(**_args(**over))


@pytest.mark.parametrize("shape, match", [
    (dict(P=129), "P <= 128"), (dict(N=257), "N <= 256"),
    (dict(Q=30000), "shared memory"), (dict(Q=0), "empty chunk"),
    # float32 lays out the CUDA-core roles, which need more shared memory
    # than the bfloat16 (tensor-core) ones at this chunk
    (dict(Q=5000, P=128, N=256), "shared memory")])
def test_cuda_wrapper_refuses_what_the_kernel_cannot_hold(no_build, shape,
                                                          match):
    with pytest.raises(ValueError, match=match):
        K.ssd_chunk(**_args(**shape))


@pytest.mark.parametrize("shape, dtype", [
    (dict(Q=5000, P=128, N=256), torch.bfloat16),
    (dict(Q=7000, P=64, N=128), torch.float32)])
def test_cuda_wrapper_limits_follow_the_dtype(no_build, shape, dtype):
    """A chunk one dtype's layout holds and the other's does not: the
    wrapper admits it (and then refuses the CPU tensors) for the one and
    refuses its shared memory for the other."""
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    assert K.admitted_smem_bytes(shape["Q"], shape["P"], shape["N"],
                                 dtype) > 0
    assert K.admitted_smem_bytes(shape["Q"], shape["P"], shape["N"],
                                 other) == -1
    args = _args(**shape)
    for name in ("x", "B_mat", "C_mat"):
        args[name] = args[name].to(dtype)
    with pytest.raises(ValueError, match="CUDA device"):
        K.ssd_chunk(**args)
    for name in ("x", "B_mat", "C_mat"):
        args[name] = args[name].to(other)
    with pytest.raises(ValueError, match="shared memory"):
        K.ssd_chunk(**args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,P,N, fits", [
    (256, 64, 128, True), (16, 129, 4, False), (16, 8, 257, False),
    (30000, 8, 4, False), (0, 8, 4, False), (4000, 128, 256, True),
    (8000, 128, 256, False)])
def test_admitted_smem_bytes_follows_the_wrapper_limits(Q, P, N, fits,
                                                        dtype):
    want = K.smem_bytes(Q, P, N, dtype) if fits else -1
    assert K.admitted_smem_bytes(Q, P, N, dtype) == want


def test_path_shape_fits_one_block():
    """The serve path's chunk (Q = 256, P = 64, N = 128, bf16) fits the
    227 KB a Hopper block may use, twice over on one SM's 228 KB (1 KB of
    it reserved per block); the JAX kernel's whole (b, h) working set
    would not fit one block."""
    path = K.smem_bytes(256, 64, 128, torch.bfloat16)
    assert 2 * (path + 1024) <= 228 * 1024
    assert K.smem_bytes(256, 64, 128) <= K.MAX_SMEM_BYTES
    whole = 4 * (256 * 64 + 2 * 256 * 128 + 256 * 256)
    assert whole > K.MAX_SMEM_BYTES
