"""AdamW in plain PyTorch: the counterpart of the JAX package's
``repro/optim/adamw.py``.

The state is ``{"m": {name: tensor}, "v": {name: tensor}, "step": int32
scalar}`` with the moments in ``moment_dtype``, keyed by the model's
parameter names.  Parameters may be bfloat16; the update math runs in
float32 and casts back.  Unlike the reference, which returns new trees,
``adamw_update`` writes the parameters and the state in place, a slice
of at most ``UPDATE_CHUNK`` elements of one parameter at a time, so only
that slice's float32 temporaries live at once (the reference orders its
per-leaf updates with an optimization barrier for the same reason, and
XLA fuses the temporaries away; eager PyTorch makes each one: the
update is elementwise, so slicing it changes no number).  Every scalar
is a float32 tensor on the device: nothing reads back to the host.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
from torch import nn

from repro_torch.config import TrainConfig

# the elements updated at once: ~6 float32 temporaries of this size live
# during an update (64 MB each), not of the largest parameter's size
UPDATE_CHUNK = 1 << 24


def adamw_init(params: nn.Module,
               moment_dtype: torch.dtype = torch.float32) -> Dict:
    """Zero moments for every parameter of ``params``, and step 0."""
    named = dict(params.named_parameters())
    dev = next(iter(named.values())).device
    return {
        "m": {k: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
              for k, p in named.items()},
        "v": {k: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
              for k, p in named.items()},
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(t.float())) for t in tensors])))


@torch.no_grad()
def adamw_update(grads: Dict[str, torch.Tensor], state: Dict,
                 params, lr: torch.Tensor,
                 tc: TrainConfig) -> tuple[nn.Module, Dict, torch.Tensor]:
    """One AdamW step with global-norm clipping.  ``params`` is a module
    or a ``{name: tensor}`` dict; ``grads`` and the moments map each name
    to its tensor.  The parameters and the state (the moments and the
    step count) are updated in place; returns (params, state, the
    gradients' global norm before clipping)."""
    step = state["step"] + 1
    named = (params if isinstance(params, dict)
             else dict(params.named_parameters()))
    gnorm = global_norm([grads[k] for k in named])
    clip = torch.clamp(tc.grad_clip / torch.clamp_min(gnorm, 1e-9), max=1.0)

    b1, b2 = tc.beta1, tc.beta2
    stepf = step.to(torch.float32)
    bc1 = 1.0 - b1 ** stepf
    bc2 = 1.0 - b2 ** stepf
    for k, p in named.items():
        flat = (p.view(-1), grads[k].reshape(-1), state["m"][k].view(-1),
                state["v"][k].view(-1))
        for p_, g, m, v in zip(*(t.split(UPDATE_CHUNK) for t in flat)):
            g = g.float() * clip
            m_new = b1 * m.float() + (1 - b1) * g
            v_new = b2 * v.float() + (1 - b2) * torch.square(g)
            mhat = m_new / bc1
            vhat = v_new / bc2
            pf = p_.float()
            delta = (mhat / (torch.sqrt(vhat) + tc.eps)
                     + tc.weight_decay * pf)
            p_.copy_(pf - lr * delta)
            m.copy_(m_new)
            v.copy_(v_new)
    state["step"].copy_(step)
    return params, state, gnorm
