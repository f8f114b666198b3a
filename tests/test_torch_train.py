"""The port's train step on the CPU against the JAX package's one-device
``make_train_step``: every ``ARCH_IDS`` smoke configuration at float32
(here; bfloat16 in ``test_torch_train_bf16.py``), with M = 1 and M = 2
microbatches.

Weights are the reference's ``init_params(cfg, PRNGKey(0))`` carried
over by ``convert.params_from_numpy``; batches (tokens, labels, the vlm
patch and audio frame embeddings) come from numpy seeds.  Both packages
take two steps with ``TrainConfig(warmup_steps=1, learning_rate=1e-3)``:
the first at lr 0 (the schedule reads the step count before the update,
as in the reference), the second moving the parameters.  Tolerances are
the families' (float32 1e-4, bfloat16 2e-2):

* each step's metrics (loss, lm_loss, aux_loss, grad_norm, lr), rtol =
  atol = tol;
* the gradients at M = 1, leaf by leaf: max|g - g_ref| <= tol * max|g_ref|.
  The reference's are read off its first moment after step 1, m = (1 -
  b1) * clip * g with clip = min(1, grad_clip / grad_norm), in float64;
* after two steps (``convert.params_to_numpy``): the parameters
  elementwise at rtol = atol = tol, the first moment leaf by leaf within
  tol of the leaf's largest value and the second, a square of the
  gradient, within 2 tol (they are ~1e-4 and ~1e-8, below any useful
  atol).

At bfloat16 a few gradient leaves are mostly rounding in both packages:
deepseek's router (top-k gates from bfloat16 activations) sits ~47% of its
largest value from the float32 gradient in either package, ~10% from each
other; a key bias, whose exact gradient is zero, is rounding alone.  So
at bfloat16 a leaf's share is the larger of 2e-2 and the reference's own
bfloat16 rounding error of that gradient leaf: its distance from the
reference's float32 gradient on the same weights, as a share of the
leaf's largest value.

Also here: remat "none", "layer" and "block" give equal numbers within
the port; one arch against the reference's "block" policy; the chunked
loss with padding and ignored labels; blockwise attention's backward
against the reference's; the kernels' ``autograd.Function``s by float64
gradcheck with the plain version standing in for the kernel; the kernel
launches that remat implies, counted through the Functions.
"""
import copy
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import models as JM  # noqa: E402
from repro.config import ARCH_IDS  # noqa: E402
from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.runtime import steps as JS  # noqa: E402
from repro_torch import config as TCF  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import RMSNormFunction  # noqa: E402
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.ssd_chunk.ops import SSDChunkFunction  # noqa: E402
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.frontend import enc_len_for  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, S = 4, 40                     # hymba's smoke window is 32: S passes it
STEP_KW = dict(warmup_steps=1, learning_rate=1e-3)
METRICS = ("loss", "lm_loss", "aux_loss", "grad_norm", "lr")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke models' ops are tiny: torch's intra-op threads gain
    nothing here and spin against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def configs(arch, dtype, **changes):
    return (dataclasses.replace(jax_smoke_config(arch), dtype=dtype,
                                **changes),
            dataclasses.replace(TCF.smoke_config(arch), dtype=dtype,
                                **changes))


def init_both(jcfg, tcfg):
    jp = jax.jit(JM.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    return jp, convert.params_from_numpy(f32_tree(jp), tcfg, "cpu")


def batches(cfg, dtype, seed=1, batch=B, seq=S):
    """The same batch for both packages."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)),
         "labels": rng.integers(0, cfg.vocab_size, (batch, seq))}
    b = {k: v.astype(np.int32) for k, v in b.items()}
    if cfg.family == "vlm":
        b["patch_embeds"] = rng.standard_normal(
            (batch, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["frame_embeds"] = rng.standard_normal(
            (batch, enc_len_for(cfg, seq), cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) if v.dtype == np.int32 else jnp.asarray(v, dtype)
          for k, v in b.items()}
    tb = {k: torch.from_numpy(v) if v.dtype == np.int32
          else torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in b.items()}
    return jb, tb


def train_configs(**kw):
    return JTrainConfig(**kw), TCF.TrainConfig(**kw)


def reference_steps(jcfg, jp, jb, tc, n=2):
    """n reference steps: (metrics per step, first moment after step 1,
    the final parameters, m and v), as float32 numpy."""
    step = jax.jit(JS.make_train_step(jcfg, tc))
    opt = j_adamw_init(jp, jnp.dtype(tc.moment_dtype))
    metrics, m1 = [], None
    for _ in range(n):
        jp, opt, m = step(jp, opt, jb)
        metrics.append({k: float(m[k]) for k in METRICS})
        m1 = f32_tree(opt["m"]) if m1 is None else m1
    return dict(metrics=metrics, m1=m1, params=f32_tree(jp),
                m=f32_tree(opt["m"]), v=f32_tree(opt["v"]))


def port_steps(tcfg, tp, tb, tc, n=2):
    """The same through the port, on a copy of ``tp``."""
    tp = copy.deepcopy(tp)
    step = steps.make_train_step(tcfg, tc)
    opt = adamw_init(tp, getattr(torch, tc.moment_dtype))
    metrics = []
    for _ in range(n):
        tp, opt, m = step(tp, opt, tb)
        metrics.append({k: float(m[k]) for k in METRICS})
    return dict(metrics=metrics,
                params=convert.params_to_numpy(tp, tcfg),
                m=convert.params_to_numpy(tp, tcfg, opt["m"]),
                v=convert.params_to_numpy(tp, tcfg, opt["v"]))


def reference_grads(ref, tc):
    """The reference's step-1 gradients from its first moment."""
    gnorm = ref["metrics"][0]["grad_norm"]
    clip = min(1.0, tc.grad_clip / max(gnorm, 1e-9))
    return jax.tree.map(
        lambda m: np.asarray(m, np.float64) / ((1 - tc.beta1) * clip),
        ref["m1"])


def reference_f32_noise(jcfg, jp, jb, tc, g_ref):
    """Per leaf, how far the reference's own bfloat16 gradient ``g_ref``
    lies from its float32 gradient on the same (bfloat16-valued) weights
    and batch, as a share of the leaf's largest bfloat16 gradient."""
    cfg32 = dataclasses.replace(jcfg, dtype="float32")
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    b32 = {k: v if v.dtype == jnp.int32 else v.astype(jnp.float32)
           for k, v in jb.items()}

    def loss(p):
        return JT.forward_train_loss(cfg32, p, b32, remat=True,
                                     remat_policy=tc.remat)[0]

    g32 = jax.jit(jax.grad(loss))(p32)
    return {path: float(np.max(np.abs(b - np.asarray(a, np.float64)))
                        / max(float(np.max(np.abs(b))), 1e-30))
            for path, a, b in leaves(g32, g_ref)}


def run_case(arch, dtype):
    """Both packages at M = 1 and M = 2, and the port's M = 1 gradients
    on the initial weights; at bfloat16 also the reference's own
    bfloat16 rounding error of each gradient leaf
    (``reference_f32_noise``)."""
    jcfg, tcfg = configs(arch, dtype)
    jp, tp = init_both(jcfg, tcfg)
    jb, tb = batches(tcfg, dtype)
    out = dict(dtype=dtype, tcfg=tcfg, runs={})
    for M in (1, 2):
        jtc, ttc = train_configs(microbatches=M, **STEP_KW)
        out["runs"][M] = (port_steps(tcfg, tp, tb, ttc),
                          reference_steps(jcfg, jp, jb, jtc))
        if M == 1:
            _, _, g = steps.loss_and_grads(
                tcfg, ttc, copy.deepcopy(tp).requires_grad_(), tb)
            out["grads"] = (convert.params_to_numpy(tp, tcfg, g),
                            reference_grads(out["runs"][1][1], jtc))
            if dtype == "bfloat16":
                out["noise"] = reference_f32_noise(jcfg, jp, jb, jtc,
                                                   out["grads"][1])
    return out


def leaves(a, b):
    pa = jax.tree_util.tree_leaves_with_path(a)
    pb = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    return [(jax.tree_util.keystr(p), x, y) for (p, x), (_, y) in
            zip(pa, pb)]


def check_metrics(case, M):
    tol = TOL[case["dtype"]]
    port, ref = case["runs"][M]
    for i, (mp, mr) in enumerate(zip(port["metrics"], ref["metrics"])):
        for k in METRICS:
            np.testing.assert_allclose(mp[k], mr[k], rtol=tol, atol=tol,
                                       err_msg=f"step {i} {k}")
    # the first step's lr is 0, the second's the peak rate
    assert port["metrics"][0]["lr"] == 0.0
    assert port["metrics"][1]["lr"] == pytest.approx(STEP_KW["learning_rate"])


def check_leaf(case, path, a, b, power=1):
    """max|a - b| within the leaf's share of its largest value: tol, or
    at bfloat16 the reference's own rounding error of that gradient leaf
    where it is larger; ``power`` 2 (the second moment, a square of the
    gradient) doubles the share."""
    share = max(TOL[case["dtype"]], case.get("noise", {}).get(path, 0.0))
    scale = float(np.max(np.abs(b)))
    err = float(np.max(np.abs(a - b)))
    assert err <= power * share * scale + 1e-30, (path, err, scale, share)


def check_grads(case):
    for path, gp, gr in leaves(*case["grads"]):
        check_leaf(case, path, gp, gr)


def check_update(case, M, what):
    tol = TOL[case["dtype"]]
    port, ref = case["runs"][M]
    for path, a, b in leaves(port[what], ref[what]):
        if what == "params":
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                       err_msg=path)
        else:
            check_leaf(case, path, a, b, power=2 if what == "v" else 1)


@pytest.fixture(scope="module", params=ARCH_IDS)
def case(request):
    return run_case(request.param, "float32")


@pytest.mark.parametrize("M", (1, 2))
def test_train_metrics(case, M):
    check_metrics(case, M)


def test_train_grads(case):
    check_grads(case)


@pytest.mark.parametrize("what", ("params", "m", "v"))
@pytest.mark.parametrize("M", (1, 2))
def test_train_update(case, M, what):
    check_update(case, M, what)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_policies_equal(arch):
    """Remat changes what is kept for backward, not the numbers: the
    loss and every gradient are equal under "none", "layer" and "block"
    (4 layers: two blocks of two)."""
    _, tcfg = configs(arch, "float32", n_layers=4)
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0),
                        "cpu").requires_grad_()
    _, tb = batches(tcfg, "float32")
    out = {}
    for policy in ("none", "layer", "block"):
        loss, _, g = steps.loss_and_grads(
            tcfg, TCF.TrainConfig(remat=policy), tp, tb)
        out[policy] = (loss, g)
    for policy in ("layer", "block"):
        assert torch.equal(out[policy][0], out["none"][0]), policy
        for k, g in out["none"][1].items():
            assert torch.equal(out[policy][1][k], g), (policy, k)


def test_block_policy_against_reference():
    """hymba (attention beside an SSM) at 4 layers, remat "block" in both
    packages (two blocks of two layers), M = 2."""
    jcfg, tcfg = configs("hymba-1.5b", "float32", n_layers=4)
    jp, tp = init_both(jcfg, tcfg)
    jb, tb = batches(tcfg, "float32")
    jtc, ttc = train_configs(remat="block", microbatches=2, **STEP_KW)
    case = dict(dtype="float32", runs={2: (port_steps(tcfg, tp, tb, ttc),
                                           reference_steps(jcfg, jp, jb,
                                                           jtc))})
    check_metrics(case, 2)
    for what in ("params", "m", "v"):
        check_update(case, 2, what)


@pytest.mark.parametrize("arch", ["olmo-1b", "llama3-8b"])
def test_chunked_lm_loss(arch):
    """Chunks of 16 over 40 positions (the last padded with label -1),
    some labels ignored (-1), a vocab padded to 256: the loss and its
    gradient in the hidden states against the reference's."""
    jcfg, tcfg = configs(arch, "float32", vocab_size=250)
    jp, tp = init_both(jcfg, tcfg)
    rng = np.random.default_rng(3)
    hidden = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, 250, (2, S)).astype(np.int32)
    labels[:, ::7] = -1

    def jloss(h):
        return JT.chunked_lm_loss(jcfg, jp, h, jnp.asarray(labels), chunk=16)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(hidden))
    h = torch.from_numpy(hidden).requires_grad_()
    tl = TT.chunked_lm_loss(tcfg, tp, h, torch.from_numpy(labels), chunk=16)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jg).max()))


ATTN_CASES = {
    "rectangular": dict(q_chunk=16, kv_chunk=16),
    "triangular": dict(q_chunk=16, kv_chunk=16, block_skip=True),
    "windowed": dict(q_chunk=16, kv_chunk=16, window=12),
    "ragged-noncausal": dict(q_chunk=16, kv_chunk=16, causal=False),
}


@pytest.mark.parametrize("kw", list(ATTN_CASES.values()),
                         ids=list(ATTN_CASES))
def test_attention_backward(kw):
    """Back-propagation through ``blockwise_attention`` (GQA, G = 3),
    against the reference's gradients of q, k and v, float32, each within
    1e-4 of its largest value."""
    rng = np.random.default_rng(5)
    Sq = 40 if kw.get("causal", True) else 37
    q = rng.standard_normal((2, Sq, 6, 8)).astype(np.float32)
    k = rng.standard_normal((2, Sq, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, Sq, 2, 8)).astype(np.float32)
    ct = rng.standard_normal(q.shape).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(JA.blockwise_attention(q, k, v, **kw) * ct)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    torch.sum(TA.blockwise_attention(*ts, **kw)
              * torch.from_numpy(ct)).backward()
    for t, g in zip(ts, jg):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(g).max()))


def _ssd_inputs(dtype, B=2, Q=6, H=3, P=4, N=5):
    """One conv output holding x, B and C (the model slices them out of
    it as views), dt positive, A negative, h: as ``ssm_forward`` passes
    them."""
    g = torch.Generator().manual_seed(0)
    f = torch.float64 if dtype == torch.float64 else torch.float32
    conv = torch.randn(B, Q, H * P + 2 * N, generator=g, dtype=f).to(dtype)
    return conv, [torch.nn.functional.softplus(
        torch.randn(B, Q, H, generator=g, dtype=f)),
        -torch.exp(torch.randn(H, generator=g, dtype=f)),
        torch.randn(B, H, P, N, generator=g, dtype=f)]


def _ssd_views(conv, dt, A, h):
    B, Q, _ = conv.shape
    H, P, N = h.shape[1:]
    return (conv[..., :H * P].reshape(B, Q, H, P), dt, A,
            conv[..., H * P:H * P + N], conv[..., H * P + N:], h)


def _ssd_function(*args):
    return SSDChunkFunction.apply(ssd_chunk_ref, ssd_chunk_ref, *args)


def test_gradcheck_rmsnorm_function():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 8, dtype=torch.float64, generator=g)
    w = torch.randn(8, dtype=torch.float64, generator=g)
    assert torch.autograd.gradcheck(
        lambda x, w: RMSNormFunction.apply(rmsnorm_ref, rmsnorm_ref, x, w,
                                           1e-6),
        (x.requires_grad_(), w.requires_grad_()))


def test_gradcheck_ssd_chunk_function():
    conv, rest = _ssd_inputs(torch.float64)
    args = [t.requires_grad_() for t in [conv] + rest]
    assert torch.autograd.gradcheck(
        lambda *a: _ssd_function(*_ssd_views(*a)), args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_function_on_views(dtype):
    """x, B and C arriving as strided views of one tensor: the Function's
    gradients equal autograd of the plain version, in each input's
    dtype."""
    conv0, rest0 = _ssd_inputs(dtype)
    grads = []
    for fn in (_ssd_function, ssd_chunk_ref):
        leaves_ = [t.clone().requires_grad_() for t in [conv0] + rest0]
        y, h = fn(*_ssd_views(*leaves_))
        (y.sum() + 2 * h.sum()).backward()
        grads.append([t.grad for t in leaves_])
    for a, b in zip(*grads):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def _counting(monkeypatch):
    """Route the model's RMSNorm and SSD-chunk calls through the kernels'
    Functions with a counting plain version standing in for each kernel,
    as a card routes them through the kernels."""
    n = {"rmsnorm": 0, "ssd_chunk": 0}

    def k_rms(x, w, eps):
        n["rmsnorm"] += 1
        return rmsnorm_ref(x, w, eps)

    def k_ssd(*a):
        n["ssd_chunk"] += 1
        return ssd_chunk_ref(*a)

    def rms(x, w, *, eps=1e-6):
        return RMSNormFunction.apply(k_rms, rmsnorm_ref, x, w, eps)

    for mod in (TL, TS, TA):
        monkeypatch.setattr(mod, "rmsnorm", rms)
    monkeypatch.setattr(TS, "ssd_chunk", lambda *a: SSDChunkFunction.apply(
        k_ssd, ssd_chunk_ref, *a))
    return n


@pytest.mark.parametrize("policy", ("none", "layer", "block"))
def test_remat_launch_counts(monkeypatch, policy):
    """mamba2 at 9 layers (three blocks of three), 2 microbatches of 2 x
    40 (two SSD chunks of 32 a layer): each microbatch runs the layers
    forward once, and backward recomputes each layer once ("layer") or,
    under nested checkpoints, each block's layers but its last once more
    before each layer again ("block": 2 * 3 - 1 = 5 a block); the
    Functions' backward launches nothing.  chip_smoke.py holds the card
    to the same counts."""
    n = _counting(monkeypatch)
    _, tcfg = configs("mamba2-370m", "float32", n_layers=9)
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    _, tb = batches(tcfg, "float32")
    tc = TCF.TrainConfig(remat=policy, microbatches=2)
    step = steps.make_train_step(tcfg, tc)
    step(tp, adamw_init(tp), tb)
    L, bs = 9, TT.block_size(9)
    layer_runs = {"none": L, "layer": 2 * L,
                  "block": L + (L // bs) * (2 * bs - 1)}[policy]
    chunks = -(-S // tcfg.ssm.chunk_size)
    assert n == {"rmsnorm": 2 * (2 * layer_runs + 1),
                 "ssd_chunk": 2 * chunks * layer_runs}
