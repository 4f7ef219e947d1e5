"""Differentiable BN affine + ReLU epilogue.

The forward pass is the kernel on a CUDA tensor; the backward pass is
plain PyTorch, as the JAX package's is plain jnp: with the ReLU mask taken
from ``y > 0``, ``dx = g * a``, ``da = sum(g * x)``, ``db = sum(g)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bn_act import kernel, ref


class _BnAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, relu):
        y = kernel.bn_act(x, a, b, relu=relu) if x.is_cuda \
            else ref.bn_act(x, a, b, relu=relu)
        ctx.relu = relu
        ctx.save_for_backward(x, a, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, a, y = ctx.saved_tensors
        md = ref.math_dtype(x.dtype)
        g = g.to(md)
        if ctx.relu:
            g = torch.where(y > 0, g, torch.zeros((), dtype=md,
                                                  device=g.device))
        dx = (g * a.to(md)[:, None, :]).to(x.dtype)
        da = (g * x.to(md)).sum(dim=1).to(a.dtype)
        db = g.sum(dim=1).to(a.dtype)
        return dx, da, db, None


def bn_act(x, a, b, *, relu=True):
    """``relu?(x * a + b)`` over the trailing channel axis, in ``x.dtype``.

    Either x (..., C) with a, b (C,), or, with a leading group axis,
    x (G, ..., C) with a, b (G, C): every group gets its own affine in one
    launch (the client forward of all clients at once). Gradients flow to
    all three operands."""
    grouped = a.dim() == 2
    c = x.shape[-1]
    g = a.shape[0] if grouped else 1
    x3 = x.reshape(g, -1, c)
    a2, b2 = (a, b) if grouped else (a[None], b[None])
    md = ref.math_dtype(a.dtype)
    y = _BnAct.apply(x3.contiguous(), a2.to(md).contiguous(),
                     b2.to(md).contiguous(), relu)
    return y.reshape(x.shape)
