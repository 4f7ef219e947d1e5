"""Differentiable BN affine + ReLU epilogue, and the BatchNorm training
op built around it.

``bn_act``: the forward pass is the kernel on a CUDA tensor; the backward
pass is plain PyTorch, as the JAX package's is plain jnp: with the ReLU
mask taken from ``y > 0``, ``dx = g * a``, ``da = sum(g * x)``,
``db = sum(g)``.

``bn_train``: one BatchNorm training (or CMSD) call with the batch's own
moments: the moments, fold and running update (``bn_moments``), K2, and a
backward through all of them (``bn_grad``), each a kernel on a CUDA
tensor and its plain version on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bn_act import kernel, ref
from repro_torch.trace import span


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


class _BnTrain(torch.autograd.Function):
    """``relu?(x * a + b)`` with ``a``, ``b`` the fold of ``stats`` (the
    batch moments of x, computed outside the graph); the backward is the
    gradient through the moments as well. Saves x and the (5, G, C)
    ``stats``; nothing f32 of x's size."""

    @staticmethod
    def forward(ctx, x, scale, bias, stats, relu):
        a, b = stats[2], stats[3]
        y = kernel.bn_act(x, a, b, relu=relu) if x.is_cuda \
            else ref.bn_act(x, a, b, relu=relu)
        ctx.relu = relu
        ctx.save_for_backward(x, stats)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, stats = ctx.saved_tensors
        grad = kernel.bn_grad if x.is_cuda else ref.bn_grad
        dx, dscale, dbias = grad(gy.contiguous(), x, stats, relu=ctx.relu)
        return dx, dscale, dbias, None, None


def bn_train(x, scale, bias, mean, var, count, *, training, relu=True,
             momentum=0.9, eps=1e-5):
    """One BatchNorm call normalised by the batch's own moments, with the
    ReLU: x (..., C) with (C,) parameters and state, or client-stacked
    x (G, ..., C) with (G, C) parameters and state and a (G,) count.

    Returns ``(y, (new mean, var, count))`` when ``training``, else
    ``(y, None)`` (CMSD). The moments run under the ``bn.stats`` span;
    call this inside ``bn.act``, which the affine and the backward are
    charged to. Gradients flow to x, scale and bias."""
    c = x.shape[-1]
    g = scale.shape[0] if scale.dim() == 2 else 1
    x3 = x.reshape(g, -1, c).contiguous()
    scale2, bias2 = scale.reshape(g, c), bias.reshape(g, c)
    run = (mean.reshape(g, c), var.reshape(g, c), count.reshape(g))
    moments = kernel.bn_moments if x.is_cuda else ref.bn_moments
    with span("bn.stats"), torch.no_grad():
        stats, new = moments(x3.detach(), scale2.detach(), bias2.detach(),
                             *run, momentum=momentum, eps=eps,
                             training=training)
    y = _BnTrain.apply(x3, scale2, bias2, stats, relu).reshape(x.shape)
    if new is None:
        return y, None
    return y, (new[0].reshape(mean.shape), new[1].reshape(var.shape),
               new[2].reshape(count.shape))
