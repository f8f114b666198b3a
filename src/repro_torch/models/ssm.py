"""Mamba-2 SSD (state-space duality) block: the chunked prefill path and
the single-step recurrent decode.

Counterpart of the JAX package's ``repro/models/ssm.py``.  The chunked
algorithm follows arXiv:2405.21060 §6: within-chunk outputs through a
masked (C Bᵀ ∘ L) term, the state carried across chunks.  Each chunk runs
the SSD-chunk kernel on a card (``kernels/ssd_chunk``), one call per
chunk in a Python loop where the JAX package has a ``lax.scan``; the
gated norm runs the RMSNorm kernel.  The causal conv and the decode step
are plain PyTorch: no TPU kernel covers them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_chunk import ssd_chunk
from repro_torch.models.layers import frozen, normal, param_dtype


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_ch


class SSM(nn.Module):
    """The mamba2 block's parameters, named as the JAX dict keys.  A_log, D
    and dt_bias are float32; the rest are in the model's dtype."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        d_inner, n_heads, conv_ch = ssm_dims(cfg)
        in_dim = 2 * d_inner + 2 * s.n_groups * s.d_state + n_heads
        dt, f32 = param_dtype(cfg), torch.float32

        def empty(*shape, dtype=dt):
            return frozen(torch.empty(shape, dtype=dtype, device=device))

        self.w_in = empty(d, in_dim)
        self.conv_w = empty(s.d_conv, conv_ch)
        self.conv_b = empty(conv_ch)
        self.A_log = empty(n_heads, dtype=f32)
        self.D = empty(n_heads, dtype=f32)
        self.dt_bias = empty(n_heads, dtype=f32)
        self.norm_scale = empty(d_inner)
        self.w_out = empty(d_inner, d)


def init_ssm(cfg: ModelConfig, generator: torch.Generator | None,
             device="cuda") -> SSM:
    p = SSM(cfg, device)
    _, n_heads, _ = ssm_dims(cfg)

    def fill(t, scale):
        t.copy_(normal(t.shape, scale, t.dtype, device, generator))

    fill(p.w_in, 0.02)
    fill(p.conv_w, 0.2)
    fill(p.w_out, 0.02 / math.sqrt(2.0 * cfg.n_layers))
    p.conv_b.zero_()
    # A_log: A = -exp(A_log), initialised in [1, 16] as in mamba2
    p.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, n_heads)))
    p.D.fill_(1.0)
    p.dt_bias.zero_()
    p.norm_scale.fill_(1.0)
    return p


# ---------------------------------------------------------------------------
# Projections shared by chunked and decode paths
# ---------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    s = cfg.ssm
    d_inner, n_heads, _ = ssm_dims(cfg)
    xbc = d_inner + 2 * s.n_groups * s.d_state
    z, xBC, dt_raw = torch.split(proj, [d_inner, xbc, n_heads], dim=-1)
    return z, xBC, dt_raw


def _gated_norm(x: torch.Tensor, z: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """Mamba-2 gated RMSNorm, norm(x * silu(z)) * scale, in float32 (x is
    float32): rsqrt(mean(y²) + 1e-6) · y · scale, through the RMSNorm
    kernel on a card."""
    y = x * F.silu(z.float())
    return rmsnorm(y, scale, eps=1e-6)


# ---------------------------------------------------------------------------
# Chunked SSD forward (prefill)
# ---------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_mat: torch.Tensor, C_mat: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None,
                out_dtype: torch.dtype | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan of  h_t = exp(A dt_t) h_{t-1} + dt_t B_t x_tᵀ ;
    y_t = C_t · h_t.

    x: (B, S, H, P); dt: (B, S, H); A: (H,) (negative); B_mat/C_mat:
    (B, S, G, N) with G = 1.  Returns y (B, S, H, P) in ``out_dtype``
    (default float32), rounded chunk by chunk as the JAX package rounds
    it, and the final state (B, H, P, N) float32.

    The last chunk may be shorter than ``chunk``: the JAX package pads it
    with zeros, which leave its outputs and final state unchanged (dt = 0
    adds no decay, x = B = 0 no state), so the port runs it at its own
    length instead.
    """
    Bsz, S, H, P = x.shape
    G, N = B_mat.shape[2], B_mat.shape[3]
    if G != 1:
        raise ValueError(f"the SSD-chunk kernel takes one group (n_groups = "
                         f"1), got {G}")
    Q = min(chunk, S)
    A = A.float()
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    ys = []
    for q0 in range(0, S, Q):
        q1 = min(q0 + Q, S)
        y, h = ssd_chunk(x[:, q0:q1], dt[:, q0:q1], A, B_mat[:, q0:q1, 0],
                         C_mat[:, q0:q1, 0], h)
        ys.append(y.to(out_dtype or y.dtype))
    return torch.cat(ys, dim=1), h


def ssm_forward(cfg: ModelConfig, p: SSM, x: torch.Tensor,
                ) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """Full-sequence mamba2 block.  x: (B, S, d_model).

    Returns (out (B, S, d_model), (ssm_state, conv_state)) for the decode
    handoff.
    """
    s = cfg.ssm
    d_inner, n_heads, _ = ssm_dims(cfg)
    B, S, _ = x.shape
    proj = torch.matmul(x, p.w_in)
    z, xBC, dt_raw = _split_proj(cfg, proj)

    # causal depthwise conv over (x, B, C): storage in x's dtype, f32 sums
    K = s.d_conv
    w = p.conv_w.float()                                       # (K, C)
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    conv = sum(pad[:, i:i + S].float() * w[i] for i in range(K))
    conv = F.silu(conv + p.conv_b.float()).to(x.dtype)
    conv_state = xBC[:, S - (K - 1):] if S >= K - 1 else F.pad(
        xBC, (0, 0, K - 1 - S, 0))

    gn = s.n_groups * s.d_state
    xs, Bm, Cm = torch.split(conv, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(B, S, n_heads, s.head_dim)
    Bm = Bm.reshape(B, S, s.n_groups, s.d_state)
    Cm = Cm.reshape(B, S, s.n_groups, s.d_state)
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())

    y, hT = ssd_chunked(xs, dt, A, Bm, Cm, s.chunk_size, out_dtype=x.dtype)
    y = y.float() + xs.float() * p.D.float()[:, None]
    y = y.reshape(B, S, d_inner)
    y = _gated_norm(y, z, p.norm_scale).to(x.dtype)
    out = torch.matmul(y, p.w_out)
    return out, (hT, conv_state.to(x.dtype))


def ssm_decode(cfg: ModelConfig, p: SSM, x: torch.Tensor,
               ssm_state: torch.Tensor, conv_state: torch.Tensor,
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step.  x: (B, 1, d_model).

    ssm_state: (B, H, P, N) float32; conv_state: (B, K-1, conv_ch).
    Returns (out (B, 1, d_model), new ssm_state, new conv_state).
    """
    s = cfg.ssm
    d_inner, n_heads, _ = ssm_dims(cfg)
    B = x.shape[0]
    proj = torch.matmul(x, p.w_in)[:, 0]                       # (B, e)
    z, xBC, dt_raw = _split_proj(cfg, proj)

    # conv ring update
    hist = torch.cat([conv_state.float(), xBC.float()[:, None]], dim=1)
    w = p.conv_w.float()
    conv = torch.einsum("bkc,kc->bc", hist, w) + p.conv_b.float()
    conv = F.silu(conv)
    new_conv_state = hist[:, 1:].to(conv_state.dtype)

    gn = s.n_groups * s.d_state
    xs, Bm, Cm = torch.split(conv, [d_inner, gn, gn], dim=-1)
    xs = xs.reshape(B, n_heads, s.head_dim)
    Bm = Bm.reshape(B, s.n_groups, s.d_state)
    Cm = Cm.reshape(B, s.n_groups, s.d_state)
    heads_per_g = n_heads // s.n_groups
    Bh = Bm.repeat_interleave(heads_per_g, dim=1)              # (B, H, N)
    Ch = Cm.repeat_interleave(heads_per_g, dim=1)

    dt = F.softplus(dt_raw.float() + p.dt_bias.float())        # (B, H)
    A = -torch.exp(p.A_log.float())
    decay = torch.exp(dt * A)                                  # (B, H)
    h = (ssm_state * decay[..., None, None]
         + torch.einsum("bh,bhn,bhp->bhpn", dt, Bh, xs))
    y = torch.einsum("bhn,bhpn->bhp", Ch, h)
    y = y + xs * p.D.float()[:, None]
    y = y.reshape(B, d_inner)
    y = _gated_norm(y, z, p.norm_scale).to(x.dtype)
    out = torch.matmul(y, p.w_out)[:, None]                    # (B, 1, d)
    return out, h, new_conv_state
