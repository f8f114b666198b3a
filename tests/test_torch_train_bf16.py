"""The port's train step at bfloat16 against the JAX package's: every
``ARCH_IDS`` smoke configuration with M = 1 and M = 2, compared as
``test_torch_train.py`` compares float32 (its docstring has the method)
at the families' bfloat16 tolerance, 2e-2.  Also: bfloat16 AdamW moments
with bfloat16 gradient accumulation, and the loss falling over 30 steps
of olmo-1b's smoke configuration (the reference's
``test_training_reduces_loss``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import ARCH_IDS  # noqa: E402
from repro_torch.config import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.config import smoke_config  # noqa: E402
from repro_torch.data import make_batch_iterator  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.runtime.steps import make_train_step  # noqa: E402
from test_torch_train import (STEP_KW, _one_torch_thread,  # noqa: E402,F401
                              batches, check_grads, check_metrics,
                              check_update, configs, init_both, port_steps,
                              reference_steps, run_case, train_configs)


@pytest.fixture(scope="module", params=ARCH_IDS)
def case(request):
    return run_case(request.param, "bfloat16")


@pytest.mark.parametrize("M", (1, 2))
def test_train_metrics_bf16(case, M):
    check_metrics(case, M)


def test_train_grads_bf16(case):
    check_grads(case)


@pytest.mark.parametrize("what", ("params", "m", "v"))
@pytest.mark.parametrize("M", (1, 2))
def test_train_update_bf16(case, M, what):
    check_update(case, M, what)


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-370m"])
def test_bf16_moments_and_accumulators(arch):
    """``moment_dtype="bfloat16"`` and ``grad_accum_dtype="bfloat16"``
    (M = 2) on float32 weights: both packages round the summed gradients
    and the moments to bfloat16 (tolerance 2e-2)."""
    jcfg, tcfg = configs(arch, "float32")
    jp, tp = init_both(jcfg, tcfg)
    jb, tb = batches(tcfg, "float32")
    kw = dict(moment_dtype="bfloat16", grad_accum_dtype="bfloat16",
              microbatches=2, **STEP_KW)
    jtc, ttc = train_configs(**kw)
    port = port_steps(tcfg, tp, tb, ttc)
    case = dict(dtype="bfloat16", runs={2: (port, reference_steps(
        jcfg, jp, jb, jtc))})
    check_metrics(case, 2)
    for what in ("params", "m", "v"):
        check_update(case, 2, what)


def test_training_reduces_loss():
    """The reference's ``test_training_reduces_loss`` through the port:
    olmo-1b's smoke configuration, 4 x 128 tokens of the synthetic
    pipeline a step, 30 steps at lr 3e-3, remat off; the loss falls by
    more than 0.5 and stays finite."""
    cfg = smoke_config("olmo-1b")
    shape = ShapeConfig("t", 128, 4, "train")
    tc = TrainConfig(learning_rate=3e-3, total_steps=30, warmup_steps=3,
                     remat="none")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = adamw_init(params)
    step = make_train_step(cfg, tc)
    data = make_batch_iterator(cfg, shape)
    losses = []
    for _ in range(30):
        batch = {k: torch.from_numpy(v) for k, v in next(data).items()}
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses[::6]
    assert all(np.isfinite(v) for v in losses)
