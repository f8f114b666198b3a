"""The port's RoPE, MLPs, attention, MoE and frontend on the CPU against
the JAX package's functions of the same names.

Inputs come from numpy seeds; JAX parameters are carried over as float32
numpy arrays and cast to the parameter's dtype, so both sides hold the
same values.  Tolerances: float32 1e-4, bfloat16 2e-2 (the JAX package's
prefill/decode tolerance), MLA 3e-2 in bfloat16, as the reference's own
MLA test uses.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import frontend as JF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JMo  # noqa: E402
from repro_torch import config as TCF  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import frontend as TF  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TMo  # noqa: E402

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MLA_TOL = {"float32": TOL["float32"],
           "bfloat16": dict(rtol=3e-2, atol=3e-2)}
DTYPES = sorted(TOL)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke models' ops are tiny: torch's intra-op threads gain
    nothing here and spin against the other test workers.  Restored for
    the files that run after in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, dtype, **kw):
    """(JAX config, port config) of ``arch``'s smoke config."""
    return (dataclasses.replace(jax_smoke_config(arch), dtype=dtype, **kw),
            dataclasses.replace(TCF.smoke_config(arch), dtype=dtype, **kw))


def _x(shape, dtype, seed, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape)
         * scale).astype(np.float32)
    return torch.from_numpy(a).to(getattr(torch, dtype)), \
        jnp.asarray(a, dtype)


def _carry(module, tree):
    """Copy a JAX parameter dict into the port's module of the same
    keys."""
    names = dict(module.named_parameters())
    assert set(names) == set(tree), (sorted(names), sorted(tree))
    with torch.no_grad():
        for k, p in names.items():
            p.copy_(torch.from_numpy(np.array(tree[k], np.float32)))
    return module


def _jit(fn, *static):
    """The JAX function compiled whole (its config the first argument,
    static), which on the CPU is faster than running it op by op."""
    return jax.jit(fn, static_argnums=(0,) if not static else (),
                   static_argnames=static)


J_MLP = _jit(JL.apply_mlp)
J_BLOCKWISE = _jit(JA.blockwise_attention, "causal", "q_offset", "window",
                   "q_chunk", "kv_chunk", "block_skip")
J_GQA_FWD = jax.jit(JA.gqa_forward, static_argnums=0,
                    static_argnames=("causal", "block_skip"))
J_GQA_DEC = _jit(JA.gqa_decode)
J_MLA_FWD = jax.jit(JA.mla_forward, static_argnums=0,
                    static_argnames=("block_skip",))
J_MLA_DEC = _jit(JA.mla_decode)
J_MOE = _jit(JMo.moe_forward)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# -- RoPE and the MLPs --------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_apply_rope(dtype, theta):
    tx, jx = _x((2, 3, 24, 16), dtype, 0)
    pos = np.arange(5, 29)
    _close(TL.apply_rope(tx, torch.from_numpy(pos), theta),
           JL.apply_rope(jx, jnp.asarray(pos), theta), TOL[dtype])
    # one position (decode), broadcast over heads
    _close(TL.apply_rope(tx[:, :, :1], torch.tensor([77]), theta),
           JL.apply_rope(jx[:, :, :1], jnp.array([77]), theta), TOL[dtype])
    np.testing.assert_allclose(TL.rope_freqs(16, theta).numpy(),
                               np.asarray(JL.rope_freqs(16, theta)),
                               rtol=1e-6)


def test_gelu_is_the_tanh_form():
    """``jax.nn.gelu`` defaults to the tanh approximation; so does the
    port's, which differs from the erf form."""
    tx, jx = _x((4096,), "float32", 1, scale=3.0)
    np.testing.assert_allclose(TL.gelu(tx).numpy(),
                               np.asarray(jax.nn.gelu(jx)), rtol=1e-6,
                               atol=1e-6)
    erf = torch.nn.functional.gelu(tx)
    assert float((erf - TL.gelu(tx)).abs().max()) > 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_variants(variant, dtype):
    jcfg, tcfg = _cfgs("llama3-8b", dtype, mlp_variant=variant)
    jp = JL.init_mlp(jcfg, jax.random.PRNGKey(3))
    tp = _carry(TL.MLP(tcfg, "cpu"), jp)
    tx, jx = _x((2, 7, tcfg.d_model), dtype, 2)
    _close(TL.apply_mlp(tcfg, tp, tx), J_MLP(jcfg, jp, jx),
           TOL[dtype])
    keys = {"swiglu": 3, "geglu": 3}.get(variant, 2)
    assert len(list(TL.init_mlp(tcfg, torch.Generator().manual_seed(0),
                                "cpu").parameters())) == keys


# -- blockwise attention ------------------------------------------------------

# (Sq, Sk, H, KVH, causal, window, q_offset, q_chunk, kv_chunk)
BLOCKWISE = [
    (64, 64, 4, 2, True, 0, 0, 16, 16),       # full blocks, GQA 2
    (40, 40, 4, 1, True, 0, 0, 16, 16),       # padding to the chunks
    (40, 40, 6, 2, False, 0, 0, 16, 8),       # non-causal, unequal chunks
    (64, 64, 4, 4, True, 8, 0, 16, 16),       # sliding window
    (48, 48, 4, 2, True, 20, 0, 16, 16),      # a window across blocks
    (24, 56, 4, 2, True, 0, 32, 8, 16),       # a q offset (a shard's rows)
    (9, 40, 2, 1, False, 0, 0, 512, 512),     # one block (the defaults)
    (33, 33, 4, 2, True, 0, 0, 512, 512),     # the serve path's default
]


@pytest.mark.parametrize("block_skip", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", BLOCKWISE)
def test_blockwise_attention(case, dtype, block_skip):
    Sq, Sk, H, KVH, causal, window, q_offset, qc, kc = case
    tq, jq = _x((2, Sq, H, 16), dtype, 10 + Sq)
    tk, jk = _x((2, Sk, KVH, 16), dtype, 20 + Sk)
    tv, jv = _x((2, Sk, KVH, 16), dtype, 30 + Sk)
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=qc,
              kv_chunk=kc, block_skip=block_skip)
    got = TA.blockwise_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, J_BLOCKWISE(jq, jk, jv, **kw), TOL[dtype])


@pytest.mark.parametrize("Sq,Sk", [(64, 64), (40, 40), (24, 40), (48, 16)])
def test_block_skip_equals_rectangular_bit_for_bit(Sq, Sk):
    """The triangular schedule skips only blocks whose every score is
    masked; those add exact zeros, so both schedules give the same
    bits."""
    tq, _ = _x((2, Sq, 4, 16), "float32", 1)
    tk, _ = _x((2, Sk, 2, 16), "float32", 2)
    tv, _ = _x((2, Sk, 2, 16), "float32", 3)
    kw = dict(causal=True, q_chunk=8, kv_chunk=8)
    assert torch.equal(TA.blockwise_attention(tq, tk, tv, **kw),
                       TA.blockwise_attention(tq, tk, tv, block_skip=True,
                                              **kw))


# -- int8 KV cache -------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 9, 3, 16), (1, 2, 5, 4, 8)])
def test_quantize_kv_bit_equal(shape, dtype):
    tx, jx = _x(shape, dtype, 4, scale=2.5)
    tq, ts = TA.quantize_kv(tx)
    jq, js = JA.quantize_kv(jx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.array_equal(TA.dequantize_kv(tq, ts).numpy(),
                          np.asarray(JA.dequantize_kv(jq, js)))
    # a zero row takes the floor scale, and rounds half to even
    z = torch.zeros((1, 1, 2, 2))
    assert TA.quantize_kv(z)[1].item() == np.float32(1e-8)
    half = torch.tensor([[[[127.0, 2.5, -3.5, 0.5]]]])     # scale 1
    assert TA.quantize_kv(half)[0].flatten().tolist() == [127, 2, -4, 0]
    assert np.array_equal(TA.quantize_kv(half)[0].numpy(),
                          np.asarray(JA.quantize_kv(jnp.asarray(
                              half.numpy()))[0]))


# -- GQA: forward, cross attention, decode -----------------------------------

@pytest.fixture(scope="module", params=[(a, d) for a in ("llama3-8b",
                                                         "qwen1.5-32b")
                                        for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def gqa(request):
    """(dtype, JAX cfg, JAX params, port cfg, port params); qwen has the
    qkv biases, drawn non-zero here so that they count."""
    arch, dtype = request.param
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = JA.init_attention(jcfg, jax.random.PRNGKey(5))
    for i, b in enumerate(k for k in ("bq", "bk", "bv") if k in jp):
        jp[b] = jnp.asarray(np.random.default_rng(i).standard_normal(
            jp[b].shape) * 0.1, jp[b].dtype)
    return dtype, jcfg, jp, tcfg, _carry(TA.Attention(tcfg, "cpu"), jp)


def test_gqa_forward_and_cross(gqa):
    dtype, jcfg, jp, tcfg, tp = gqa
    tx, jx = _x((2, 20, tcfg.d_model), dtype, 6)
    for bs in (False, True):
        (o, (k, v)) = TA.gqa_forward(tcfg, tp, tx,
                                     positions=torch.arange(20),
                                     block_skip=bs)
        (jo, (jk, jv)) = J_GQA_FWD(jcfg, jp, jx,
                                        positions=jnp.arange(20),
                                        block_skip=bs)
        for a, b in ((o, jo), (k, jk), (v, jv)):
            _close(a, b, TOL[dtype])
    te, je = _x((2, 11, tcfg.d_model), dtype, 7)
    tkv, jkv = TA.cross_kv(tcfg, tp, te), JA.cross_kv(jcfg, jp, je)
    for a, b in zip(tkv, jkv):
        _close(a, b, TOL[dtype])
    o, _ = TA.gqa_forward(tcfg, tp, tx, positions=torch.arange(20),
                          causal=False, kv_override=tkv)
    jo, _ = J_GQA_FWD(jcfg, jp, jx, positions=jnp.arange(20),
                      causal=False, kv_override=jkv)
    _close(o, jo, TOL[dtype])


@pytest.mark.parametrize("window,S,position", [
    (0, 16, 9), (0, 16, 15), (0, 16, 20),      # the last: past the end
    (8, 8, 5), (8, 8, 13), (8, 8, 30)])        # ring buffer, wrapped
@pytest.mark.parametrize("int8", [False, True])
def test_gqa_decode(gqa, window, S, position, int8):
    """One step against a cache of random rows: the outputs and the
    written caches (the ring slot, and past the end the clamped last
    slot, as ``dynamic_update_slice`` clamps)."""
    dtype, jcfg, jp, tcfg, tp = gqa
    jcfg = dataclasses.replace(jcfg, sliding_window=window)
    tcfg = dataclasses.replace(tcfg, sliding_window=window)
    shape = (2, S, tcfg.n_kv_heads, tcfg.d_head)
    tck, jck = _x(shape, dtype, 8)
    tcv, jcv = _x(shape, dtype, 9)
    tx, jx = _x((2, 1, tcfg.d_model), dtype, 10)
    pos = torch.tensor(position, dtype=torch.int32)
    if int8:
        tck, tks = TA.quantize_kv(tck)
        tcv, tvs = TA.quantize_kv(tcv)
        jck, jks = JA.quantize_kv(jck)
        jcv, jvs = JA.quantize_kv(jcv)
        got = TA.gqa_decode(tcfg, tp, tx, tck.clone(), tcv.clone(), pos,
                            k_scale=tks.clone(), v_scale=tvs.clone())
        want = J_GQA_DEC(jcfg, jp, jx, jck, jcv, jnp.int32(position),
                         k_scale=jks, v_scale=jvs)
    else:
        got = TA.gqa_decode(tcfg, tp, tx, tck.clone(), tcv.clone(), pos)
        want = J_GQA_DEC(jcfg, jp, jx, jck, jcv, jnp.int32(position))
    assert len(got) == len(want)
    _close(got[0], want[0], TOL[dtype])
    for a, b in zip(got[1:], want[1:]):
        if a.dtype == torch.int8:
            # the new row's rounding may flip on a last-ulp difference
            d = np.abs(a.numpy().astype(int) - np.asarray(b).astype(int))
            assert d.max() <= (0 if dtype == "float32" else 1)
        else:
            _close(a, b, TOL[dtype])


def test_gqa_decode_leaves_the_other_rows(gqa):
    """Only the new token's slot is written; ``update_cache=False``
    writes nothing."""
    dtype, _, _, tcfg, tp = gqa
    tck, _ = _x((1, 6, tcfg.n_kv_heads, tcfg.d_head), dtype, 11)
    tx, _ = _x((1, 1, tcfg.d_model), dtype, 12)
    k, v = tck.clone(), tck.clone()
    _, k2, v2 = TA.gqa_decode(tcfg, tp, tx, k, v, torch.tensor(3))
    assert k2 is k and v2 is v
    keep = [0, 1, 2, 4, 5]
    assert torch.equal(k[:, keep], tck[:, keep])
    assert not torch.equal(k[:, 3], tck[:, 3])
    k, v = tck.clone(), tck.clone()
    TA.gqa_decode(tcfg, tp, tx, k, v, torch.tensor(3), update_cache=False)
    assert torch.equal(k, tck) and torch.equal(v, tck)


# -- MLA ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=[(q, d) for q in (True, False)
                                        for d in DTYPES],
                ids=lambda p: f"q_lora{int(p[0])}-{p[1]}")
def mla(request):
    q_lora, dtype = request.param
    jcfg, tcfg = _cfgs("deepseek-v2-236b", dtype)
    if not q_lora:
        jcfg = dataclasses.replace(
            jcfg, mla=dataclasses.replace(jcfg.mla, q_lora_rank=0))
        tcfg = dataclasses.replace(
            tcfg, mla=dataclasses.replace(tcfg.mla, q_lora_rank=0))
    jp = JA.init_attention(jcfg, jax.random.PRNGKey(13))
    jp = {k: (jnp.asarray(np.random.default_rng(1).uniform(
        0.5, 1.5, v.shape), v.dtype) if "norm" in k else v)
        for k, v in jp.items()}
    return dtype, jcfg, jp, tcfg, _carry(TA.Attention(tcfg, "cpu"), jp)


def test_mla_forward(mla):
    dtype, jcfg, jp, tcfg, tp = mla
    assert ("wq_a" in jp) == bool(tcfg.mla.q_lora_rank)
    tx, jx = _x((2, 21, tcfg.d_model), dtype, 14)
    for bs in (False, True):
        o, (ckv, kr) = TA.mla_forward(tcfg, tp, tx,
                                      positions=torch.arange(21),
                                      block_skip=bs)
        jo, (jckv, jkr) = J_MLA_FWD(jcfg, jp, jx,
                                         positions=jnp.arange(21),
                                         block_skip=bs)
        for a, b in ((o, jo), (ckv, jckv), (kr, jkr)):
            _close(a, b, MLA_TOL[dtype])


@pytest.mark.parametrize("position", [0, 7, 15])
def test_mla_decode(mla, position):
    dtype, jcfg, jp, tcfg, tp = mla
    m = tcfg.mla
    tc, jc = _x((2, 16, m.kv_lora_rank), dtype, 15)
    tr, jr = _x((2, 16, m.qk_rope_head_dim), dtype, 16)
    tx, jx = _x((2, 1, tcfg.d_model), dtype, 17)
    got = TA.mla_decode(tcfg, tp, tx, tc.clone(), tr.clone(),
                        torch.tensor(position, dtype=torch.int32))
    want = J_MLA_DEC(jcfg, jp, jx, jc, jr, jnp.int32(position))
    for a, b in zip(got, want):
        _close(a, b, MLA_TOL[dtype])


# -- MoE ----------------------------------------------------------------------

MOE_CASES = [("grok-1-314b", 1.25), ("deepseek-v2-236b", 1.25),
             ("grok-1-314b", 0.5), ("deepseek-v2-236b", 0.3)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,cap", MOE_CASES)
def test_moe_forward(arch, cap, dtype):
    """The routing first (top-k indices and renormalised gates), then the
    Switch aux, the capacity and the output; the small capacity factors
    drop tokens.  deepseek has a shared expert, grok is geglu."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jcfg = dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cap))
    tcfg = dataclasses.replace(
        tcfg, moe=dataclasses.replace(tcfg.moe, capacity_factor=cap))
    jp = JMo.init_moe(jcfg, jax.random.PRNGKey(17))
    tp = _carry(TMo.MoE(tcfg, "cpu"), jp)
    tx, jx = _x((3, 13, tcfg.d_model), dtype, 18)
    T, e = 3 * 13, tcfg.moe
    # routing: the router in float32, then top-k
    probs = torch.softmax(tx.reshape(T, -1).float()
                          @ tp.router.float(), -1)
    jprobs = jax.nn.softmax(jx.reshape(T, -1).astype(jnp.float32)
                            @ jp["router"].astype(jnp.float32), -1)
    g, idx = torch.topk(probs, e.top_k, dim=-1)
    jg, jidx = jax.lax.top_k(jprobs, e.top_k)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    C = TMo._capacity(T, tcfg, e.n_experts)
    assert C == JMo._capacity(T, jcfg, e.n_experts)
    per_expert = np.bincount(idx.numpy().ravel(), minlength=e.n_experts)
    assert (per_expert.max() > C) == (cap < 1.0)    # drops at capacity
    out, aux = TMo.moe_forward(tcfg, tp, tx)
    jout, jaux = J_MOE(jcfg, jp, jx)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    _close(out, jout, TOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert ("shared_gate" in jp) == bool(e.n_shared_experts)


def test_expert_ffn_chunks_give_the_same_bits(monkeypatch):
    """Upcasting the experts in chunks changes nothing: every expert's
    products are the same float32 products."""
    _, tcfg = _cfgs("deepseek-v2-236b", "bfloat16")
    p = TMo.init_moe(tcfg, torch.Generator().manual_seed(0), "cpu")
    xin, _ = _x((tcfg.moe.n_experts, 5, tcfg.d_model), "bfloat16", 19)
    whole = TMo._expert_ffn(tcfg, xin, p.w_gate, p.w_up, p.w_down)
    monkeypatch.setattr(TMo, "EXPERT_CHUNK_BYTES", 3 * tcfg.d_model
                        * tcfg.moe.expert_d_ff * 4)
    assert torch.equal(whole, TMo._expert_ffn(tcfg, xin, p.w_gate, p.w_up,
                                              p.w_down))
    assert whole.dtype == torch.float32


# -- the frontend -------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["whisper-small", "llava-next-mistral-7b"])
def test_frontend(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = JF.init_frontend(jcfg, jax.random.PRNGKey(21))
    jp["proj_b"] = jnp.asarray(np.linspace(-1, 1, tcfg.d_model),
                               jp["proj_b"].dtype)
    tp = _carry(TF.Frontend(tcfg, "cpu"), jp)
    te, je = _x((2, 9, tcfg.d_model), dtype, 22)
    _close(TF.apply_frontend(tcfg, tp, te),
           JF.apply_frontend(jcfg, jp, je), TOL[dtype])
    init = TF.init_frontend(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert init.proj_w.shape == (tcfg.d_model, tcfg.d_model)
    assert torch.equal(init.proj_b, torch.zeros_like(init.proj_b))
    for length, d in ((9, tcfg.d_model), (100, 768), (1, 6)):
        np.testing.assert_allclose(
            TF.sinusoidal_positions(length, d).numpy(),
            np.asarray(JF.sinusoidal_positions(length, d)),
            **TOL["float32"])
    assert TF.enc_len_for(tcfg, 448) == JF.enc_len_for(jcfg, 448)
