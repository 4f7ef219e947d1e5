"""Plain PyTorch version of the fused RMSNorm."""
from __future__ import annotations

import torch


def rmsnorm_ref(x, scale, *, eps=1e-6, scale_offset=0.0):
    """``x / sqrt(mean(x^2) + eps) * (scale + scale_offset)`` over the last
    axis, in f32, returned in ``x.dtype``."""
    x32 = x.float()
    ms = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 / torch.sqrt(ms + eps)
    return (y * (scale.float() + scale_offset)).to(x.dtype)
