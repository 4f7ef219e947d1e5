"""Plain PyTorch version of the folded BN affine + ReLU epilogue."""
from __future__ import annotations

import torch


def math_dtype(dtype):
    """f32 for f32 and narrower inputs (the kernel's working type); f64
    stays f64 so gradcheck can run on the plain path."""
    return torch.promote_types(dtype, torch.float32)


def bn_act(x, a, b, *, relu=True):
    """x: (G, rows, C); a, b: (G, C). ``relu?(x * a + b)`` computed in f32
    (multiply, then add) and returned in ``x.dtype``."""
    md = math_dtype(x.dtype)
    y = x.to(md) * a.to(md)[:, None, :] + b.to(md)[:, None, :]
    if relu:
        y = torch.where(y < 0, torch.zeros((), dtype=md, device=y.device), y)
    return y.to(x.dtype)
