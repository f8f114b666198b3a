"""The even-odd Schur operator as the inner CG's normal operator takes it,
on the CPU: ``schur_matvec`` / ``schur_matvec_dagger`` with an inner type
against the composition they replaced (the rounding through the inner
type, the Schur axpy ``psi - (kappa * kappa) * d`` and gamma5 around two
plain hops, written out here), bit for bit; the inner CG driven by either
normal operator; the fused wrapper's refusals.  On the card the same
operators are two launches of B1 each: ``tests/test_torch_gpu.py``.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.dslash import kernel as K  # noqa: E402
from repro_torch.kernels.dslash import ref  # noqa: E402
from repro_torch.lqcd import cg as TC  # noqa: E402
from repro_torch.lqcd import dirac as TD  # noqa: E402
from repro_torch.lqcd import eo as TE  # noqa: E402
from repro_torch.lqcd.su3 import random_field_and_source  # noqa: E402

LATTICES = [(4, 4, 4, 4), (4, 4, 4, 8)]
INNER = [None, torch.bfloat16, torch.float16, torch.float64]
KAPPA = 0.23


def _setup(lattice, inner, seed=11):
    U, b = random_field_and_source(lattice, seed, "cpu")
    U_e, U_o = TE.pack_gauge(U)
    return (TC._round_complex(U_e, inner), TC._round_complex(U_o, inner),
            TE.eo_pack(b, 0) * 3.0)


# the composition the Schur operators replaced, as the solver spelled it
def _schur(U_e, U_o, psi, kappa):
    d_oe = TE.dslash_half(U_o, U_e, psi, src_parity=0)
    d_eo = TE.dslash_half(U_e, U_o, d_oe, src_parity=1)
    return psi - (kappa * kappa) * d_eo


def _schur_dagger(U_e, U_o, psi, kappa):
    return TD.gamma5(_schur(U_e, U_o, TD.gamma5(psi), kappa))


def _normal_lo(U_e, U_o, v, kappa, inner):
    v = TC._round_complex(v, inner)
    av = TC._round_complex(_schur(U_e, U_o, v, kappa), inner)
    out = _schur_dagger(U_e, U_o, av, kappa)
    return TC._round_complex(out, inner)


@pytest.mark.parametrize("dagger", [False, True])
@pytest.mark.parametrize("inner", INNER, ids=str)
@pytest.mark.parametrize("lattice", LATTICES, ids=str)
def test_schur_equals_the_composition(lattice, inner, dagger):
    U_e, U_o, v = _setup(lattice, inner)
    r = lambda t: TC._round_complex(t, inner)  # noqa: E731
    if dagger:
        want = r(_schur_dagger(U_e, U_o, v, KAPPA))
        got = TE.schur_matvec_dagger(U_e, U_o, v, KAPPA, inner)
    else:
        want = r(_schur(U_e, U_o, r(v), KAPPA))
        got = TE.schur_matvec(U_e, U_o, v, KAPPA, inner)
    assert got.dtype == torch.complex64
    assert torch.equal(got, want)
    assert torch.equal(got, TE.schur_composed(U_e, U_o, v, KAPPA,
                                              dagger=dagger,
                                              inner_dtype=inner))
    if inner is None:       # the operators' old signatures, unchanged
        old = _schur_dagger if dagger else _schur
        fn = TE.schur_matvec_dagger if dagger else TE.schur_matvec
        assert torch.equal(fn(U_e, U_o, v, KAPPA), old(U_e, U_o, v, KAPPA))


@pytest.mark.parametrize("inner", INNER, ids=str)
@pytest.mark.parametrize("lattice", LATTICES, ids=str)
def test_normal_op_equals_the_composition(lattice, inner):
    U_e, U_o, v = _setup(lattice, inner)
    av = TE.schur_matvec(U_e, U_o, v, KAPPA, inner)
    got = TE.schur_matvec_dagger(U_e, U_o, av, KAPPA, inner)
    assert torch.equal(got, _normal_lo(U_e, U_o, v, KAPPA, inner))


@pytest.mark.parametrize("inner", INNER, ids=str)
def test_inner_cg_unchanged(inner):
    """The inner CG's iterations and answer, driven by the solver's
    normal operator or by the composition it replaced."""
    U_e, U_o, v = _setup((4, 4, 4, 4), inner, seed=5)
    kappa = 0.12

    def new(p):
        av = TE.schur_matvec(U_e, U_o, p, kappa, inner)
        return TE.schur_matvec_dagger(U_e, U_o, av, kappa, inner)

    want = TC.cg_solve(lambda p: _normal_lo(U_e, U_o, p, kappa, inner), v,
                       tol=1e-2, max_iters=200)
    got = TC.cg_solve(new, v, tol=1e-2, max_iters=200)
    assert got.iters == want.iters > 0
    assert torch.equal(got.x, want.x)


@pytest.mark.parametrize("dagger", [False, True])
@pytest.mark.parametrize("inner", [torch.float32, torch.complex64,
                                   torch.float64], ids=str)
def test_inner_types_that_round_nothing(inner, dagger):
    """f32, complex64 and f64 hold every f32 value: through them the
    Schur operator is the one with no inner type, as the card's fused
    operator takes them too (``kernel._ROUND``)."""
    U_e, U_o, v = _setup((4, 4, 4, 4), None)
    fn = TE.schur_matvec_dagger if dagger else TE.schur_matvec
    assert torch.equal(fn(U_e, U_o, v, KAPPA, inner),
                       fn(U_e, U_o, v, KAPPA))
    assert K._ROUND[inner] == 0


@pytest.mark.parametrize("lattice", LATTICES, ids=str)
def test_cpu_schur_launches_nothing(lattice):
    U_e, U_o, v = _setup(lattice, torch.bfloat16)
    before = dict(K.LAUNCHES)
    TE.schur_matvec_dagger(U_e, U_o,
                           TE.schur_matvec(U_e, U_o, v, KAPPA,
                                           torch.bfloat16),
                           KAPPA, torch.bfloat16)
    assert K.LAUNCHES == before
    assert set(K.LAUNCHES) == {"dslash_split", "dslash_eo_split",
                               "dslash_eo_fused"}


@pytest.mark.parametrize("case", ["inner", "dtype", "shape", "contiguity",
                                  "device"])
def test_fused_wrapper_refuses(case):
    U_e, U_o, v = _setup((4, 4, 4, 4), None)
    args = [ref.to_split(U_e), ref.to_split(U_o), ref.to_split(v)]
    kw = {"inner_dtype": None}
    err, match = ValueError, {"inner": "inner_dtype", "dtype": "float32",
                              "shape": "U_o_s", "contiguity": "contiguous",
                              "device": "CUDA device"}[case]
    if case == "inner":
        kw["inner_dtype"] = torch.int8
    elif case == "dtype":
        args[2], err = args[2].double(), TypeError
    elif case == "shape":
        args[1] = args[1][:, :1].contiguous()
    elif case == "contiguity":
        args[2] = args[2].transpose(1, 2)
    before = dict(K.LAUNCHES)
    with pytest.raises(err, match=match):
        K.schur_eo_split(*args, KAPPA, **kw)
    assert K.LAUNCHES == before
