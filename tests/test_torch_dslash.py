"""The port's D-slash kernel module on the CPU: the plain versions of the
two kernels against the JAX package's Pallas kernels (run as the JAX tests
run them off-TPU, in interpret mode), CPU dispatch of the ops wrappers,
and the CUDA wrappers' refusal of what the kernels cannot take.  The
kernels themselves run in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.dslash import dslash_half_pallas, dslash_pallas  # noqa: E402
from repro.lqcd import eo as JE  # noqa: E402
from repro.lqcd import su3 as JS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.dslash import kernel as K  # noqa: E402
from repro_torch.kernels.dslash import ops, ref  # noqa: E402
from repro_torch.lqcd import eo as TE  # noqa: E402

LATTICES = [(4, 4, 4, 4), (4, 4, 4, 8), (8, 4, 4, 8)]
TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_kernels.py::test_dslash_sweep


@functools.lru_cache(maxsize=None)
def _fields(shape):
    rng = np.random.default_rng(100 + sum(shape))
    m = (rng.standard_normal((4,) + shape + (3, 3))
         + 1j * rng.standard_normal((4,) + shape + (3, 3)))
    U = np.asarray(JS.su3_project(jnp.asarray(m.astype(np.complex64))))
    psi = (rng.standard_normal(shape + (4, 3))
           + 1j * rng.standard_normal(shape + (4, 3))).astype(np.complex64)
    return (U, psi, convert.gauge_from_numpy(U, "cpu"),
            convert.spinor_from_numpy(psi, "cpu"))


@pytest.mark.parametrize("lattice", LATTICES)
def test_dslash_split_ref_matches_pallas(lattice):
    U, psi, tU, tpsi = _fields(lattice)
    got = ref.from_split(ref.dslash_split_ref(ref.to_split(tU),
                                              ref.to_split(tpsi)))
    np.testing.assert_allclose(got.numpy(), np.asarray(dslash_pallas(U, psi)),
                               **TOL)


@pytest.mark.parametrize("src_parity", [0, 1])
@pytest.mark.parametrize("lattice", LATTICES)
def test_dslash_eo_split_ref_matches_pallas(lattice, src_parity):
    U, psi, tU, tpsi = _fields(lattice)
    jUe, jUo = JE.pack_gauge(U)
    tUe, tUo = TE.pack_gauge(tU)
    want = dslash_half_pallas(jUe, jUo, JE.eo_pack(psi, src_parity),
                              src_parity)
    to, ts = (tUo, tUe) if src_parity == 0 else (tUe, tUo)
    got = ref.dslash_eo_split_ref(ref.to_split(to), ref.to_split(ts),
                                  ref.to_split(TE.eo_pack(tpsi, src_parity)),
                                  src_parity)
    np.testing.assert_allclose(ref.from_split(got).numpy(), np.asarray(want),
                               **TOL)


def test_split_views_are_free():
    _, _, tU, tpsi = _fields(LATTICES[0])
    s = ref.to_split(tpsi)
    assert s.dtype == torch.float32 and s.shape == tpsi.shape + (2,)
    assert s.data_ptr() == tpsi.data_ptr()
    assert ref.from_split(s).data_ptr() == tpsi.data_ptr()
    np.testing.assert_array_equal(ref.from_split(s).numpy(), tpsi.numpy())
    # a lazily conjugated or strided input is materialised first
    np.testing.assert_array_equal(ref.from_split(ref.to_split(tU.conj())),
                                  tU.conj().resolve_conj().numpy())


def test_ops_cpu_dispatch_runs_plain_versions():
    """On CPU tensors the ops take the plain versions and launch nothing."""
    _, _, tU, tpsi = _fields(LATTICES[1])
    before = dict(K.LAUNCHES)
    got = ops.dslash_op(tU, tpsi)
    want = ref.from_split(ref.dslash_split_ref(ref.to_split(tU),
                                               ref.to_split(tpsi)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    tUe, tUo = TE.pack_gauge(tU)
    half = TE.eo_pack(tpsi, 1)
    got = ops.dslash_half_op(tUe, tUo, half, 1)
    want = ref.dslash_eo_split_ref(ref.to_split(tUe), ref.to_split(tUo),
                                   ref.to_split(half), 1)
    np.testing.assert_array_equal(got.numpy(), ref.from_split(want).numpy())
    assert K.LAUNCHES == before


def _split_inputs(shape=(4, 4, 4, 4)):
    _, _, tU, tpsi = _fields(shape)
    return ref.to_split(tU), ref.to_split(tpsi)


@pytest.mark.parametrize("case", ["dtype", "shape", "links", "contiguity",
                                  "device"])
def test_full_wrapper_refuses(case):
    U_s, psi_s = _split_inputs()
    err = ValueError
    if case == "dtype":
        psi_s, err = psi_s.double(), TypeError
    elif case == "shape":
        psi_s = psi_s[..., :2, :, :].contiguous()
    elif case == "links":
        U_s = U_s[:, :2].contiguous()
    elif case == "contiguity":
        psi_s = psi_s.transpose(0, 1)
    match = {"dtype": "float32", "shape": "psi_s must have shape",
             "links": "U_s must have shape", "contiguity": "contiguous",
             "device": "CUDA device"}[case]
    with pytest.raises(err, match=match):
        K.dslash_split(U_s, psi_s)


@pytest.mark.parametrize("case", ["dtype", "shape", "contiguity", "device",
                                  "parity"])
def test_eo_wrapper_refuses(case):
    U_s, psi_s = _split_inputs()
    U_h, psi_h = U_s[:, :2].contiguous(), psi_s[:2].contiguous()
    args = [U_h, U_h.clone(), psi_h, 0]
    err, match = ValueError, {"dtype": "float32", "shape": "U_src_s",
                              "contiguity": "contiguous",
                              "device": "CUDA device",
                              "parity": "src_parity"}[case]
    if case == "dtype":
        args[0], err = U_h.to(torch.bfloat16), TypeError
    elif case == "shape":
        args[1] = U_s
    elif case == "contiguity":
        args[2] = psi_h.transpose(1, 2)
    elif case == "parity":
        args[3] = 2
    with pytest.raises(err, match=match):
        K.dslash_eo_split(*args)
    assert K.LAUNCHES["dslash_eo_split"] == 0


def test_build_is_lazy_and_keyed_by_source():
    """Importing the kernels builds nothing; the library's name follows
    the sources' hash and lives in the ignored build directory."""
    assert "dslash" not in _build._libs
    path = _build.library_path("dslash")
    assert path.parent == _build.BUILD_DIR
    assert path.parent.relative_to(_build.KERNELS_DIR.parents[2]).parts[0] \
        == "build"
    assert path == _build.library_path("dslash")
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
