"""Every architecture's serve path in the port, on the CPU, against the JAX
package's: the smoke configuration of each id in ``ARCH_IDS`` at float32
and bfloat16.

Weights are the JAX package's ``init_params(cfg, PRNGKey(0))`` (jitted),
carried over by ``convert.params_from_numpy``; prompts (and the vlm patch and
audio frame embeddings) come from numpy seeds.  Both packages decode the
same tokens, the JAX package's greedy picks.  Tolerances: float32 1e-4,
bfloat16 2e-2 (the JAX package's prefill/decode tolerance).  An int8
cache entry may differ by one quantum in float32, where a last-ulp
difference flips a rounding tie, and by two in bfloat16, where the K/V
rounded to bfloat16 before quantizing differ by an ulp (0.4%, up to half
a quantum at the row's maximum) and so may the row's scale; fewer than 5%
of the entries may differ at all.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as JM  # noqa: E402
from repro.config import ARCH_IDS  # noqa: E402
from repro.config import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import steps as JS  # noqa: E402
from repro_torch import config as TCF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import frontend as TF  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = sorted(TOL)
INT8_QUANTA = {"float32": 1, "bfloat16": 2}
B, S, GEN = 2, 40, 4             # hymba's smoke window is 32: S wraps it


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke models' ops are tiny: torch's intra-op threads gain
    nothing here and spin against the other test workers.  Restored for
    the files that run after in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batch(cfg, dtype, seed=1):
    """The same prompt (and embeddings) for both packages."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["frame_embeds"] = rng.standard_normal(
            (B, TF.enc_len_for(cfg, S), cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) if k == "tokens" else jnp.asarray(v, dtype)
          for k, v in b.items()}
    tb = {k: torch.from_numpy(v) if k == "tokens"
          else torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in b.items()}
    return jb, tb


def _run(jcfg, tcfg, jp, tp, jb, tb, quantize):
    """Prefill, grow, then GEN decode steps in both packages.  Returns the
    (port, JAX) prefill logits and cache, and per step the (port, JAX)
    logits, and the (port, JAX) caches after the last step."""
    jl, jc = jax.jit(JS.make_prefill_step(jcfg, quantize_kv_cache=quantize))(
        jp, jb)
    tl, tc = steps.make_prefill_step(tcfg, quantize_kv_cache=quantize)(tp, tb)
    out = {"prefill": (tl, jl), "prefill_cache": (tc, jc)}
    total = S + GEN + (tcfg.n_patches if tcfg.family == "vlm" else 0)
    jc = JS.grow_decode_cache(jcfg, jc, B, total, quantize_kv_cache=quantize)
    tc = steps.grow_decode_cache(tcfg, tc, B, total,
                                 quantize_kv_cache=quantize)
    jdec, tdec = jax.jit(JS.make_decode_step(jcfg)), \
        steps.make_decode_step(tcfg)
    out["decode"] = []
    for _ in range(GEN):
        tok = np.asarray(jnp.argmax(jl[:, :jcfg.vocab_size], -1),
                         np.int32)[:, None]
        jl, jc = jdec(jp, jnp.asarray(tok), jc)
        tl, tc = tdec(tp, torch.from_numpy(tok), tc)
        out["decode"].append((tl, jl))
    out["decode_cache"] = (tc, jc)
    return out


@pytest.fixture(scope="module",
                params=[(a, d) for a in ARCH_IDS for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def family(request):
    arch, dtype = request.param
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(TCF.smoke_config(arch), dtype=dtype)
    # compiled whole: on the CPU faster than op by op
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    tp = convert.params_from_numpy(_f32(jp), tcfg, "cpu")
    jb, tb = _batch(tcfg, dtype)
    # an ssm or MLA cache holds no K/V: quantize_kv_cache leaves it be
    runs = {q: _run(jcfg, tcfg, jp, tp, jb, tb, q) for q in (False, True)}
    return dict(dtype=dtype, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, tb=tb,
                runs=runs)


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _cache_close(got, want, dtype):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], np.asarray(want[k])
        assert tuple(g.shape) == w.shape, k
        if k == "pos":
            assert g.dtype == torch.int32 and int(g) == int(w)
        elif g.dtype == torch.int8:
            assert w.dtype == np.int8
            d = np.abs(g.numpy().astype(int) - w.astype(int))
            assert d.max() <= INT8_QUANTA[dtype] and (d > 0).mean() < 0.05, k
        else:
            _close(g, w, dtype)


def test_configs_are_copies():
    """Every architecture's smoke and full configuration equals the JAX
    package's, field for field and in its parameter count."""
    from repro.config import get_arch as jax_get_arch
    for arch in ARCH_IDS:
        for fn in ("full", "smoke"):
            t = getattr(TCF.get_arch(arch), fn)()
            j = getattr(jax_get_arch(arch), fn)()
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.param_count() == j.param_count()


def test_weights_carry_over_bit_for_bit(family):
    tp, jp = family["tp"], family["jp"]
    want = jax.tree_util.tree_flatten_with_path(_f32(jp))[0]
    got = dict(tp.named_parameters())
    seen = set()
    for path, a in want:
        keys = [p.key for p in path]
        stacked = keys[0] in ("layers", "enc_layers")
        for i in range(a.shape[0] if stacked else 1):
            name = ".".join([keys[0], str(i)] + keys[1:] if stacked
                            else keys)
            assert np.array_equal(got[name].float().numpy(),
                                  a[i] if stacked else a), name
            seen.add(name)
    assert seen == set(got)
    assert all(p.dtype == getattr(torch, family["dtype"])
               or p.dtype == torch.float32 for p in got.values())


@pytest.mark.parametrize("quantize", [False, True], ids=["cache", "int8"])
def test_prefill(family, quantize):
    """The last token's logits and every cache entry (stacked over layers;
    with a window, the ring-aligned last rows)."""
    run = family["runs"][quantize]
    tl, jl = run["prefill"]
    _close(tl, jl, family["dtype"])
    _cache_close(*run["prefill_cache"], family["dtype"])


@pytest.mark.parametrize("quantize", [False, True], ids=["cache", "int8"])
def test_decode_steps(family, quantize):
    """GEN decode steps from the grown cache: each step's logits, and the
    caches after the last."""
    run = family["runs"][quantize]
    for tl, jl in run["decode"]:
        _close(tl, jl, family["dtype"])
    _cache_close(*run["decode_cache"], family["dtype"])
    assert int(run["decode_cache"][0]["pos"]) == int(
        run["prefill_cache"][0]["pos"]) + GEN


def test_decode_leaves_its_input_cache(family):
    """The cache passed to a decode step is not modified."""
    tcfg, tp = family["tcfg"], family["tp"]
    _, cache = steps.make_prefill_step(tcfg)(tp, family["tb"])
    cache = steps.grow_decode_cache(tcfg, cache, B, S + 80)
    before = {k: v.clone() for k, v in cache.items()}
    steps.make_decode_step(tcfg)(tp, torch.zeros((B, 1), dtype=torch.int32),
                                 cache)
    assert all(torch.equal(cache[k], before[k]) for k in before)


def test_block_skip_equals_the_rectangular_schedule(family):
    tcfg, tp = family["tcfg"], family["tp"]
    tl, tc = steps.make_prefill_step(tcfg, block_skip=True)(tp,
                                                            family["tb"])
    rl, rc = family["runs"][False]["prefill"][0], \
        family["runs"][False]["prefill_cache"][0]
    assert torch.equal(tl, rl)
    assert all(torch.equal(tc[k], rc[k]) for k in rc)


def test_grow_decode_cache(family):
    """The grown cache has ``init_decode_cache``'s layout; the prefilled
    entries fill its leading slices and the rest is zero, as the JAX
    package grows it."""
    tcfg, jcfg = family["tcfg"], family["jcfg"]
    tc, jc = family["runs"][False]["prefill_cache"]
    total = S + 80 + (tcfg.n_patches if tcfg.family == "vlm" else 0)
    got = steps.grow_decode_cache(tcfg, tc, B, total)
    want = JS.grow_decode_cache(jcfg, jc, B, total)
    _cache_close(got, want, family["dtype"])
    ref = TT.init_decode_cache(tcfg, B, total, device="cpu")
    assert {k: (v.shape, v.dtype) for k, v in got.items()} == \
        {k: (v.shape, v.dtype) for k, v in ref.items()}


def test_cache_carries_over(family):
    """A JAX cache through ``convert.cache_from_numpy`` decodes as the
    port's own."""
    tcfg, tp = family["tcfg"], family["tp"]
    for quantize, run in family["runs"].items():
        jc = run["prefill_cache"][1]
        got = convert.cache_from_numpy(_f32(jc), tcfg, "cpu")
        assert {k: v.dtype for k, v in got.items()} == \
            {k: v.dtype for k, v in run["prefill_cache"][0].items()}
        _cache_close(got, jc, family["dtype"])
        tok = torch.zeros((B, 1), dtype=torch.int32)
        a, _ = TT.forward_decode(tcfg, tp, tok, got)
        b, _ = TT.forward_decode(tcfg, tp, tok, run["prefill_cache"][0])
        _close(a, b.float().numpy(), family["dtype"])
    with pytest.raises(ValueError, match="a decode cache has pos"):
        convert.cache_from_numpy({"pos": 0, "kv": 0}, tcfg, "cpu")


def test_kv_cache_bytes_and_init_layout(family):
    tcfg, jcfg = family["tcfg"], family["jcfg"]
    for seq in (8, 100):
        assert TT.kv_cache_bytes(tcfg, 3, seq) == JT.kv_cache_bytes(
            jcfg, 3, seq)
        for q in (False, True):
            got = TT.init_decode_cache(tcfg, 3, seq, quantize_kv_cache=q,
                                       device="cpu")
            want = JM.init_decode_cache(jcfg, 3, seq, quantize_kv_cache=q)
            assert set(got) == set(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape
                assert str(got[k].dtype)[6:] == str(want[k].dtype)
                assert not got[k].any()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_cli_on_the_cpu(arch, capsys):
    """The model run of every architecture, with and without the int8
    cache, prints the reference's lines: the plan, prefill, decode, three
    energy lines, the sample."""
    for flags in ([], ["--kv-int8"]):
        serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                    "--prompt-len", "12", "--gen", "3", *flags])
        out = capsys.readouterr().out.splitlines()
        assert out[0].startswith("[energy] decode dominant=")
        assert out[1].startswith("prefill 12 tokens x 2:")
        assert out[2].startswith("decoded 3 tokens x 2 in")
        assert [line.split()[1] for line in out[3:6]] == \
            ["prefill", "decode", "total"]
        assert out[6].startswith("sample: [") and len(out) == 7
