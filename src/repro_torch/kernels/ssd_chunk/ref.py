"""Plain PyTorch version of the SSD-chunk kernel: the oracle on the card
and the path the CPU takes.  It repeats the arithmetic of the JAX
package's ``_ssd_kernel`` (``src/repro/kernels/ssd_chunk/kernel.py:18``),
which is ``ssd_chunked``'s ``chunk_step`` (``src/repro/models/ssm.py:115``)
for one group, over all batches and heads at once."""
from __future__ import annotations

import torch


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B_mat: torch.Tensor, C_mat: torch.Tensor,
                  h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One Mamba-2 SSD chunk.

    x: (B, Q, H, P); dt: (B, Q, H); A: (H,); B_mat/C_mat: (B, Q, N);
    h: (B, H, P, N).  Returns (y (B, Q, H, P), h_new (B, H, P, N)), both
    float32 (float64 where x is float64, so that
    ``torch.autograd.gradcheck`` can run it).
    """
    acc = torch.promote_types(x.dtype, torch.float32)
    xf, dtf = x.to(acc), dt.to(acc)
    bm, cm, hf = B_mat.to(acc), C_mat.to(acc), h.to(acc)
    q = x.shape[1]
    cs = torch.cumsum(dtf * A.to(acc), dim=1)                 # (B, Q, H)
    # L[i, j] = exp(cs_i - cs_j) for i >= j.  Mask BEFORE exp: the upper
    # triangle's differences are positive and would overflow.
    diff = cs[:, :, None, :] - cs[:, None, :, :]               # (B, Q, Q, H)
    tri = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
    lm = torch.exp(torch.where(tri[None, :, :, None], diff,
                               torch.tensor(-1e30, device=x.device)))
    cb = torch.einsum("bqn,bkn->bqk", cm, bm)                  # (B, Q, Q)
    w = cb[..., None] * lm * dtf[:, None, :, :]                # (B, Q, Q, H)
    y = torch.einsum("bqkh,bkhp->bqhp", w, xf)                 # intra-chunk
    y = y + torch.einsum("bqn,bhpn,bqh->bqhp", cm, hf,
                         torch.exp(cs))                        # inter-chunk
    decay_end = torch.exp(cs[:, -1:, :] - cs) * dtf            # (B, Q, H)
    h_new = (hf * torch.exp(cs[:, -1, :])[..., None, None]
             + torch.einsum("bqhp,bqn,bqh->bhpn", xf, bm, decay_end))
    return y, h_new
