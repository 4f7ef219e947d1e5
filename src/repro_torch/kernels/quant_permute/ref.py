"""Plain PyTorch versions of the fused quantize-permute gathers.

Quantization is ``core.wire``'s (bitwise equal to the JAX package's);
these compose it with the plain gathers, so the kernels have an exact
target and the collector's CPU path shares one implementation with the
tests.
"""
from __future__ import annotations

from repro_torch.core import wire as W


def quant_bucket_permute(x, idx, wire_dtype):
    """x: (R, d) float rows; idx: (S, cap) or flat (S*cap,). Returns
    ``(q, scales)`` with ``q[k] = quantize(x[idx.flat[k]])`` in the wire
    dtype and f32 scales (S*cap,) in the same bucketed order."""
    return W.quantize_rows(x[idx.reshape(-1)], wire_dtype)


def dequant_unbucket_permute(q, scales, idx, out_dtype):
    """q: (R, d) wire rows with (R,) f32 scales; idx: (B,). Returns the
    dequantized gathered rows ``q[idx] * scales[idx]`` in ``out_dtype``."""
    return W.dequantize_rows(q[idx], scales[idx], out_dtype)
