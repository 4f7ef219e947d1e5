"""Differentiable collector shuffle: the gradient of a row gather by a
permutation is the gather by the inverse permutation, so Algorithm 1's
gradient de-shuffle is the same kernel run backwards."""
from __future__ import annotations

import torch

from repro_torch.kernels.collector_permute import kernel, ref


def inverse_permutation(perm):
    """``inv[perm[i]] = i`` by one O(n) scatter (no sort)."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.numel(), device=perm.device,
                             dtype=perm.dtype)
    return inv


def _gather(x, perm):
    if x.is_cuda:
        return kernel.collector_permute(x, perm)
    return ref.collector_permute(x, perm)


class _CollectorPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm):
        ctx.save_for_backward(perm)
        return _gather(x, perm)

    @staticmethod
    def backward(ctx, g):
        (perm,) = ctx.saved_tensors
        return _gather(g.contiguous(), inverse_permutation(perm)), None


def collector_permute(x, perm):
    """``x[perm]`` along axis 0 for a float tensor ``x`` (R, ...) and an
    int64 permutation ``perm`` (R,); differentiable in ``x``."""
    return _CollectorPermute.apply(x.contiguous(), perm.long())
