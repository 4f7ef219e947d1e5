"""Flash attention in the model's layout, forward only.

``src/repro/kernels/flash_attention/ops.py`` defines no VJP for the TPU
kernel, so the JAX package cannot train through it; the port's wrapper
keeps that: its backward raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if q.is_cuda:
            return kernel.flash_attention(q, k, v, causal=causal,
                                          window=window, scale=scale)
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 scale=scale)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "flash attention is forward-only: the JAX package's "
            "kernels/flash_attention/ops.py defines no VJP for its kernel; "
            "train on the xla attention path")


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, Sq, H, D); k/v: (B, Skv, K, D). Returns (B, Sq, H, D) in
    q.dtype: the kernel on CUDA tensors, :func:`ref.attention_ref` on CPU
    ones. Masks by aligned positions 0..S-1 (causal, ``iq - ik <
    window``)."""
    return _FlashAttention.apply(q, k, v, causal, window, scale)
