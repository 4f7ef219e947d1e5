"""RMSNorm over the last axis through the K6 kernel, forward only.

The JAX package's wrapper defines no VJP for its kernel, and no model
calls it; so a gradient through this wrapper raises instead of
differentiating something the reference never did.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import kernel, ref


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, scale, eps, scale_offset):
        if x2.is_cuda:
            return kernel.rmsnorm(x2, scale, eps=eps,
                                  scale_offset=scale_offset)
        return ref.rmsnorm_ref(x2, scale, eps=eps, scale_offset=scale_offset)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "rmsnorm kernel is forward-only: the JAX package's "
            "kernels/rmsnorm/ops.py defines no VJP for it either")


def rmsnorm(x, scale, *, eps=1e-6, scale_offset=0.0):
    """x: (..., d) in any float dtype; scale: (d,). The kernel on a CUDA
    tensor, the plain version on a CPU one; returned in ``x.dtype``."""
    d = x.shape[-1]
    x2 = x.reshape(-1, d)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    y = _RmsNorm.apply(x2, scale.contiguous(), float(eps),
                       float(scale_offset))
    return y.reshape(x.shape)
