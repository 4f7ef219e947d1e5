"""Wrappers of the fused quantize-permute gathers (K5a, K5b).

They speak the exchange's flattened layout: the collector packs the
quantized rows and the bitcast scale lanes into one 2-D wire payload for
the ``all_to_all``, so the ops take and return ``(rows, features)``
tensors (``quant_bucket_permute`` flattens nd inputs itself). Each runs
its kernel on a CUDA tensor and its plain version on a CPU one.
"""
from __future__ import annotations

import torch

from repro_torch.core import wire as W
from repro_torch.kernels.quant_permute import kernel, ref


def _flat(x):
    return x.reshape(x.shape[0], -1)


def quant_bucket_permute(x, idx, *, wire_dtype):
    """Fused send-side quantize + bucket gather: x (R, ...) float rows,
    idx (S, cap) (or flat) -> ``(q, scales)``, q (S*cap, d) in the wire
    dtype with the feature dims flattened and f32 scales (S*cap,), both in
    send-bucket order."""
    x2 = _flat(x)
    if x2.is_cuda:
        return kernel.quant_bucket_permute(x2.contiguous(),
                                           idx.contiguous(), wire_dtype)
    return ref.quant_bucket_permute(x2, idx, wire_dtype)


def quant_bucket_permute_packed(x, idx, *, wire_dtype):
    """:func:`quant_bucket_permute` as the one-operand wire payload
    ``(S*cap, d + SCALE_LANES)``: q columns then the bitcast scale lanes.
    The kernel writes it in place; the plain version concatenates."""
    x2 = _flat(x)
    if x2.is_cuda:
        return kernel.quant_bucket_permute(x2.contiguous(),
                                           idx.contiguous(), wire_dtype,
                                           packed=True)
    q, scales = ref.quant_bucket_permute(x2, idx, wire_dtype)
    return torch.cat([q, W.pack_scales(scales, wire_dtype)], dim=1)


def dequant_unbucket_permute(q, scales, idx, *, out_dtype):
    """Fused receive-side gather + dequantize: q (R, d) wire rows, scales
    (R,) f32, idx (B,) -> the (B, d) dequantized rows in ``out_dtype``."""
    if q.is_cuda:
        return kernel.dequant_unbucket_permute(q, scales, idx.contiguous(),
                                               out_dtype)
    return ref.dequant_unbucket_permute(q, scales, idx, out_dtype)


def dequant_unbucket_permute_packed(payload, idx, *, out_dtype):
    """:func:`dequant_unbucket_permute` of a packed ``(R, d + LANES)``
    payload: the kernel reads the q view and the scale lanes in place."""
    d = payload.shape[1] - W.SCALE_LANES
    q, lanes = payload[:, :d], payload[:, d:]
    if payload.is_cuda:
        return kernel.dequant_unbucket_permute(q, lanes, idx.contiguous(),
                                               out_dtype)
    return ref.dequant_unbucket_permute(q, W.unpack_scales(lanes), idx,
                                        out_dtype)


class _RoundTrip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send_idx, recv_idx, wire_dtype):
        ctx.save_for_backward(send_idx, recv_idx)
        ctx.shape = x.shape
        q, s = quant_bucket_permute(x, send_idx, wire_dtype=wire_dtype)
        out = dequant_unbucket_permute(q, s, recv_idx, out_dtype=x.dtype)
        return out.reshape((recv_idx.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, g):
        send_idx, recv_idx = ctx.saved_tensors
        src = send_idx.reshape(-1)[recv_idx]        # out[i] <- x[src[i]]
        gx = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        return gx.index_add_(0, src, g), None, None, None


def quant_dequant_roundtrip_ad(x, send_idx, recv_idx, wire_dtype):
    """Differentiable fused round trip: ``quant_bucket_permute`` then
    ``dequant_unbucket_permute`` (what one quantized exchange does to the
    rows, minus the collective). The gradient is straight-through:
    dequantize-of-quantize counts as the identity, so gradients route by
    the composed gather alone, the convention ``plan_shuffle``'s backward
    exchange follows."""
    return _RoundTrip.apply(x, send_idx, recv_idx, wire_dtype)
