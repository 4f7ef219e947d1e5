"""Differentiable collector gathers.

The shuffle (K1): the gradient of a row gather by a permutation is the
gather by the inverse permutation, so Algorithm 1's gradient de-shuffle is
the same kernel run backwards.

The route plan's bucket gathers (K4a/K4b): their index maps are not known
to be permutations (slack-padded plans repeat filler rows), so their
gradient is a scatter-add, ``gx[idx[k]] += g[k]``, in plain PyTorch as the
JAX package's ``_ad`` wrappers have it. The collector's own gradient
exchange never comes through here: it rides the precomputed backward plan
(``core.collector_dist.plan_shuffle``). These exist for direct autograd
through the gathers.
"""
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


def bucket_gather(x, idx):
    """K4a on a CUDA tensor, its plain version on a CPU one: ``x`` (R, ...)
    float, ``idx`` (S, cap) int32/int64 -> (S*cap, ...). Not
    differentiable (see :func:`bucket_permute`)."""
    if x.is_cuda:
        return kernel.bucket_permute(x.contiguous(), idx.contiguous())
    return ref.bucket_permute(x, idx)


def unbucket_gather(x, idx):
    """K4b on a CUDA tensor, its plain version on a CPU one: ``x`` (R, ...)
    float, ``idx`` (B,) int32/int64 -> (B, ...)."""
    if x.is_cuda:
        return kernel.unbucket_permute(x.contiguous(), idx.contiguous())
    return ref.unbucket_permute(x, idx)


def _scatter_add(g, idx, rows):
    gx = torch.zeros((rows,) + tuple(g.shape[1:]), dtype=g.dtype,
                     device=g.device)
    return gx.index_add_(0, idx.reshape(-1), g)


class _BucketPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return bucket_gather(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _scatter_add(g, idx, ctx.rows), None


class _UnbucketPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.rows = x.shape[0]
        return unbucket_gather(x, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _scatter_add(g, idx, ctx.rows), None


def bucket_permute(x, idx):
    """Differentiable send-side bucket gather: ``x`` (R, ...) float,
    ``idx`` (S, cap) -> ``out[s*cap + r] = x[idx[s, r]]``; the gradient
    scatter-adds, so repeated source rows accumulate."""
    return _BucketPermute.apply(x, idx)


def unbucket_permute(x, idx):
    """Differentiable receive-side gather ``out[i] = x[idx[i]]`` (the
    :func:`bucket_permute` mirror, same scatter-add gradient)."""
    return _UnbucketPermute.apply(x, idx)
