"""The port's mamba2 serve path on the CPU against the JAX package's.

Weights are the JAX package's ``init_params(smoke_config("mamba2-370m"),
PRNGKey(0))``, carried over by ``convert.params_from_numpy``; prompts come
from numpy seeds.  Tolerances: float32 at 1e-4 (the measured gap is below
2e-6 on logits and 1e-8 on the SSM state; the two packages sum in other
orders), bfloat16 at 2e-2, the JAX package's own prefill/decode tolerance
(tests/test_attention_ssm.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as JM  # noqa: E402
from repro.config import smoke_config as jax_smoke_config  # noqa: E402
from repro.configs import mamba2_370m as jax_mamba2  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch import config as TCF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import models as TM  # noqa: E402
from repro_torch.configs import mamba2_370m as t_mamba2  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as RK  # noqa: E402
from repro_torch.kernels.ssd_chunk import kernel as SK  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

ARCH = "mamba2-370m"
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = sorted(TOL)


@pytest.fixture(scope="module", params=DTYPES)
def models(request):
    """(dtype, JAX config, JAX params, port config, port model)."""
    dtype = request.param
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(TCF.smoke_config(ARCH), dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    return dtype, jcfg, jp, tcfg, convert.params_from_numpy(tree, tcfg,
                                                            "cpu")


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


def _x(shape, dtype, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(getattr(torch, dtype)), \
        jnp.asarray(a, dtype)


def test_configs_are_copies():
    for fn in ("full", "smoke"):
        t, j = getattr(t_mamba2, fn)(), getattr(jax_mamba2, fn)()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.vocab_padded == j.vocab_padded
    assert t_mamba2.full().param_count() == 368_126_976
    assert TCF.ARCH_IDS == __import__("repro.config").config.ARCH_IDS


def test_other_architectures_raise():
    """Every architecture's configuration is there and equal to the JAX
    package's, and the model of every family initialises (the attention,
    MLP and MoE families run since they were ported; their parity is in
    tests/test_torch_families.py); an unknown architecture raises."""
    llama = TCF.get_arch("llama3-8b").smoke()
    assert dataclasses.asdict(llama) == dataclasses.asdict(
        __import__("repro.config").config.get_arch("llama3-8b").smoke())
    for arch in TCF.ARCH_IDS:
        cfg = TCF.smoke_config(arch)
        model = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        assert len(model.layers) == cfg.n_layers
        assert hasattr(model.layers[0], "attn") == (cfg.family != "ssm")
    with pytest.raises(KeyError):
        TCF.get_arch("no-such-model")


def test_weights_carry_over_bit_for_bit(models):
    dtype, _, jp, tcfg, tp = models
    assert tp.embed.tokens.dtype == getattr(torch, dtype)
    assert tp.layers[1].ssm.A_log.dtype == torch.float32
    for got, want in ((tp.embed.tokens, jp["embed"]["tokens"]),
                      (tp.layers[1].ssm.w_in, jp["layers"]["ssm"]["w_in"][1]),
                      (tp.layers[0].ssm.A_log,
                       jp["layers"]["ssm"]["A_log"][0])):
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want, np.float32))


def test_apply_norm(models):
    dtype, jcfg, jp, tcfg, tp = models
    tx, jx = _x((2, 7, jcfg.d_model), dtype, 1)
    _close(TL.apply_norm(tcfg, tp.layers[0].norm1, tx),
           JL.apply_norm(jcfg, {"scale": jp["layers"]["norm1"]["scale"][0]},
                         jx), dtype)


@pytest.mark.parametrize("variant", ["layernorm", "nonparametric_ln"])
def test_apply_norm_layernorm_variants(variant):
    """The variants mamba2 does not use stay plain PyTorch."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32",
                               norm_variant=variant)
    tcfg = dataclasses.replace(TCF.smoke_config(ARCH), dtype="float32",
                               norm_variant=variant)
    rng = np.random.default_rng(5)
    p = TL.init_norm(tcfg, "cpu")
    jp = {}
    for k, t in p.named_parameters():
        a = rng.standard_normal(t.shape).astype(np.float32)
        t.copy_(torch.from_numpy(a))
        jp[k] = jnp.asarray(a)
    assert set(jp) == set(JL.init_norm(jcfg, jax.random.PRNGKey(0)))
    tx, jx = _x((3, 64), "float32", 6)
    _close(TL.apply_norm(tcfg, p, tx), JL.apply_norm(jcfg, jp, jx),
           "float32")


def test_untied_lm_head():
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32",
                               tie_embeddings=False, vocab_size=250)
    tcfg = dataclasses.replace(TCF.smoke_config(ARCH), dtype="float32",
                               tie_embeddings=False, vocab_size=250)
    head = TL.init_lm_head(tcfg, torch.Generator().manual_seed(0), "cpu")
    embed = TL.init_embedding(tcfg, torch.Generator().manual_seed(1), "cpu")
    assert head.w.shape == (64, 256)
    tx, jx = _x((2, 64), "float32", 7)
    got = TL.lm_head_logits(tcfg, embed, head, tx)
    want = JL.lm_head_logits(jcfg, {}, {"w": jnp.asarray(head.w.numpy())},
                             jx)
    _close(got[:, :250], np.asarray(want)[:, :250], "float32")
    assert bool((got[:, 250:] == -1e30).all())


def _layer0(jp):
    return jax.tree.map(lambda a: a[0], jp["layers"]["ssm"])


@pytest.mark.parametrize("S", [17, 40])
def test_ssm_forward(models, S):
    dtype, jcfg, jp, tcfg, tp = models
    tx, jx = _x((2, S, jcfg.d_model), dtype, S)
    out, (h, conv) = TS.ssm_forward(tcfg, tp.layers[0].ssm, tx)
    jout, (jh, jconv) = jax.jit(JS.ssm_forward, static_argnums=0)(
        jcfg, _layer0(jp), jx)
    assert out.dtype == tx.dtype and h.dtype == torch.float32
    _close(out, jout, dtype)
    _close(h, jh, dtype)
    _close(conv, jconv, dtype)


def test_ssm_decode(models):
    dtype, jcfg, jp, tcfg, tp = models
    tx, jx = _x((2, 1, jcfg.d_model), dtype, 3)
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 8, 16, 16)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 160)).astype(np.float32)
    out, h2, conv2 = TS.ssm_decode(
        tcfg, tp.layers[0].ssm, tx, torch.from_numpy(h),
        torch.from_numpy(conv).to(tx.dtype))
    jout, jh2, jconv2 = jax.jit(JS.ssm_decode, static_argnums=0)(
        jcfg, _layer0(jp), jx, jnp.asarray(h), jnp.asarray(conv, dtype))
    _close(out, jout, dtype)
    _close(h2, jh2, dtype)
    _close(conv2, jconv2, dtype)


def test_ssd_chunked_needs_one_group():
    x = torch.zeros(1, 4, 2, 3)
    bm = torch.zeros(1, 4, 2, 5)
    with pytest.raises(ValueError, match="one group"):
        TS.ssd_chunked(x, torch.zeros(1, 4, 2), torch.zeros(2), bm, bm, 4)


def _tokens(cfg, B, S):
    return np.random.default_rng(S).integers(0, cfg.vocab_size, (B, S))


def _compare_cache(got, want, dtype):
    assert set(got) == set(want) == {"pos", "ssm", "conv"}
    assert int(got["pos"]) == int(want["pos"])
    assert got["pos"].dtype == torch.int32
    assert got["ssm"].dtype == torch.float32
    assert got["conv"].dtype == getattr(torch, dtype)
    _close(got["ssm"], want["ssm"], dtype)
    _close(got["conv"], want["conv"], dtype)


@pytest.mark.parametrize("S", [17, 32, 40])
def test_prefill_then_decode(models, S):
    """Prefill below, at and past one 32-token chunk (the last one ragged),
    then 4 chained decode steps fed with each package's own greedy
    tokens, which must be equal."""
    dtype, jcfg, jp, tcfg, tp = models
    toks = _tokens(jcfg, 2, S)
    V = jcfg.vocab_size
    rk, sk = dict(RK.LAUNCHES), dict(SK.LAUNCHES)
    logits, cache = steps.make_prefill_step(tcfg)(
        tp, {"tokens": torch.from_numpy(toks)})
    jlogits, jcache = jax.jit(lambda p, b: JM.forward_prefill(jcfg, p, b))(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    assert logits.shape == (2, jcfg.vocab_padded)
    _close(logits, jlogits, dtype)
    _compare_cache(cache, jcache, dtype)
    cache = steps.grow_decode_cache(tcfg, cache, 2, S + 4)
    decode = steps.make_decode_step(tcfg)
    jdecode = jax.jit(lambda p, t, c: JM.forward_decode(jcfg, p, t, c))
    tok = torch.argmax(logits[:, :V], -1)[:, None]
    jtok = jnp.argmax(jlogits[:, :V], -1)[:, None]
    for _ in range(4):
        assert np.array_equal(tok.numpy(), np.asarray(jtok))
        logits, cache = decode(tp, tok, cache)
        jlogits, jcache = jdecode(jp, jtok.astype(jnp.int32), jcache)
        _close(logits, jlogits, dtype)
        tok = torch.argmax(logits[:, :V], -1)[:, None]
        jtok = jnp.argmax(jlogits[:, :V], -1)[:, None]
    _compare_cache(cache, jcache, dtype)
    assert int(cache["pos"]) == S + 4
    assert RK.LAUNCHES == rk and SK.LAUNCHES == sk   # plain versions only


def test_decode_from_a_carried_over_cache(models):
    dtype, jcfg, jp, tcfg, tp = models
    jlogits, jcache = jax.jit(JM.forward_prefill, static_argnums=0)(
        jcfg, jp, {"tokens": jnp.asarray(_tokens(jcfg, 2, 9), jnp.int32)})
    cache = convert.cache_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jcache), tcfg,
        "cpu")
    _compare_cache(cache, jcache, dtype)
    tok = np.array(jnp.argmax(jlogits, -1))[:, None]
    logits, _ = TM.forward_decode(tcfg, tp, torch.from_numpy(tok), cache)
    want, _ = jax.jit(JM.forward_decode, static_argnums=0)(
        jcfg, jp, jnp.asarray(tok, jnp.int32), jcache)
    _close(logits, want, dtype)


def test_padded_vocab_tail_is_masked():
    cfg = dataclasses.replace(TCF.smoke_config(ARCH), vocab_size=250)
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits, _ = TM.forward_prefill(cfg, tp, {
        "tokens": torch.from_numpy(_tokens(cfg, 1, 5))})
    assert logits.shape == (1, 256)
    assert bool((logits[:, 250:] < -1e29).all())
    assert bool((logits[:, :250] > -1e3).all())


def test_init_decode_cache_layout():
    cfg = TCF.smoke_config(ARCH)
    c = TM.init_decode_cache(cfg, 3, 100, device="cpu")
    assert c["ssm"].shape == (2, 3, 8, 16, 16)
    assert c["conv"].shape == (2, 3, 3, 160)
    assert c["conv"].dtype == torch.bfloat16 and int(c["pos"]) == 0


def test_params_from_numpy_checks_the_tree(models):
    dtype, jcfg, jp, tcfg, _ = models
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    tree["layers"]["ssm"]["w_in"] = tree["layers"]["ssm"]["w_in"][:, :3]
    with pytest.raises(ValueError, match="w_in must have shape"):
        convert.params_from_numpy(tree, tcfg, "cpu")
    tree = jax.tree.map(lambda a: np.asarray(a), jp)
    if dtype == "bfloat16":
        with pytest.raises(TypeError, match="float32"):
            convert.params_from_numpy(tree, tcfg, "cpu")


def test_serve_cli_on_the_cpu(capsys):
    serve.main(["--arch", ARCH, "--device", "cpu", "--batch", "2",
                "--prompt-len", "40", "--gen", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[energy] decode dominant=")
    assert out[1].startswith("prefill 40 tokens x 2:")
    assert out[2].startswith("decoded 3 tokens x 2 in")
    assert all(line.startswith("[energy] ") for line in out[3:6])
    assert out[6].startswith("sample: [")


@pytest.mark.parametrize("flag, first", [
    (["--kv-int8"], "[energy]"),
    (["--replay", "{trace}", "--executed", "--kv-int8"], "[replay]"),
    (["--replay", "{trace}", "--executed", "--arch", "olmo-1b"], "[replay]"),
    (["--arch", "olmo-1b"], "[energy]")])
def test_serve_cli_refuses_what_is_not_ported(flag, first, tmp_path, capsys):
    """What the CLI refused before the attention families were ported now
    runs: the model runs of another family and ``--kv-int8``, plain and
    through the executed replay; an unknown architecture is refused."""
    trace = tmp_path / "x.npz"
    serve.main(["--make-demo-trace", str(trace), "--arch", "olmo-1b",
                "--batch", "2", "--prompt-len", "12", "--gen", "3"])
    capsys.readouterr()
    flag = [f.format(trace=trace) for f in flag]
    serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "12",
                "--gen", "3", *flag])
    out = capsys.readouterr().out
    assert out.startswith(first) and "sample: [" in out
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--arch", "no-such-model"])


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TCF.smoke_config(ARCH)
    for call in (lambda: TM.init_params(cfg),
                 lambda: TM.init_decode_cache(cfg, 1, 8),
                 lambda: serve.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
