"""Gradients through the hand-written kernels.

The JAX package's gradients are XLA's autodiff of plain jnp: its model
calls no Pallas kernel (``src/repro/models/layers.py:38-51`` and the SSD
scan of ``models/ssm.py`` are plain jnp) and it defines no
``custom_vjp``.  So the port's backward for a kernel is autograd of the
kernel's plain version: ``KernelFunction`` runs the hand-written kernel
forward and saves its inputs; backward recomputes the plain version from
them under ``torch.enable_grad()`` and returns its gradients, each in its
input's dtype.  Backward launches no kernel.  Each kernel family
subclasses it, so a profile names its backward (``<Class>Backward``).
"""
from __future__ import annotations

import torch


class KernelFunction(torch.autograd.Function):
    """``apply(kernel, plain, *args)``: ``kernel(*args)`` forward, the
    gradient of ``plain(*args)`` backward.  ``args`` may mix tensors with
    other values (an ``eps``); only tensors get gradients."""

    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.others = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        ctx.save_for_backward(*(a for a in args
                                if isinstance(a, torch.Tensor)))
        return kernel(*args)

    @staticmethod
    def backward(ctx, *grad_out):
        saved = iter(ctx.saved_tensors)
        needs = ctx.needs_input_grad[2:]
        args = [next(saved).detach().requires_grad_(need) if t else a
                for t, a, need in zip(ctx.is_tensor, ctx.others, needs)]
        want = [a for a, need in zip(args, needs) if need]
        with torch.enable_grad():
            out = ctx.plain(*args)
        out = out if isinstance(out, tuple) else (out,)
        grads = iter(torch.autograd.grad(out, want, grad_out,
                                         allow_unused=True))
        return (None, None) + tuple(next(grads) if need else None
                                    for need in needs)


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd records an operation on ``tensors`` here."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
