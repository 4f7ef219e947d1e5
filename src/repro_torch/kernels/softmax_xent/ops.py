"""Differentiable fused softmax cross-entropy.

The per-row rule (``nll`` forward, ``(softmax - onehot) * g`` backward) is
the kernel pair on a CUDA tensor. The ignore index and the mean over valid
rows stay outside it, so autograd hands the backward sweep the per-row
scale ``where(valid, g / denom, 0)``, which zeroes ignored rows.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.softmax_xent import kernel, ref
from repro_torch.models.common import valid_count

IGNORE_LABEL = -100


class _XentRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, labels):
        nll, lse = kernel.xent_fwd(x, labels) if x.is_cuda \
            else ref.xent_fwd(x, labels)
        ctx.save_for_backward(x, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        x, labels, lse = ctx.saved_tensors
        g = g.to(lse.dtype).contiguous()
        dx = kernel.xent_bwd(x, labels, lse, g) if x.is_cuda \
            else ref.xent_bwd(x, labels, lse, g)
        return dx, None


def softmax_xent(logits, labels, *, ignore=IGNORE_LABEL, reduce=None):
    """Fused drop-in for ``softmax_cross_entropy``: logits (..., V) in any
    float dtype, labels (...,) int. Mean nll over non-ignored rows, in f32
    (``max(#valid, 1)`` in the denominator, so all-ignored gives 0);
    ``reduce`` counts the valid rows of every rank, as there."""
    v = logits.shape[-1]
    x2 = logits.reshape(-1, v).contiguous()
    lab = labels.reshape(-1).long()
    valid = lab != ignore
    safe = torch.where(valid, lab, torch.zeros((), dtype=lab.dtype,
                                               device=lab.device))
    nll = _XentRows.apply(x2, safe.contiguous())
    nll = torch.where(valid, nll, torch.zeros((), dtype=nll.dtype,
                                              device=nll.device))
    return nll.sum() / valid_count(valid, reduce)
