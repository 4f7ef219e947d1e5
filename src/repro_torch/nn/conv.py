"""2-D convolution with NHWC activations and XLA's "SAME" padding.

Weights are stored as PyTorch likes them, ``(out, in, kh, kw)``; a
client-stacked weight carries a leading client axis ``(N, out, in, kh,
kw)`` and then takes a client-stacked input ``(N, B, H, W, C)``: every
client's conv runs in one grouped convolution (the JAX package's ``vmap``
over clients, written out).

"SAME" pads ``(lo, hi)`` with ``lo = total // 2`` as XLA does, so a 3x3
stride-2 conv on an even input pads (0, 1), where ``padding=1`` would pad
(1, 1): the same output shape with different values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.init import he_normal


def conv2d_init(gen, in_ch, out_ch, kernel, *, dtype=torch.float32):
    """A bias-free ``kernel`` x ``kernel`` conv, He-normal, stored OIHW."""
    w = he_normal(gen, (kernel, kernel, in_ch, out_ch), dtype=dtype,
                  in_axis=2, out_axis=3)
    return {"w": w.permute(3, 2, 0, 1).contiguous()}


def _same_pad(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv2d_apply(params, x, *, stride=1, compute_dtype=None):
    """x: (B, H, W, C) with w (O, I, kh, kw), or client-stacked
    (N, B, H, W, C) with w (N, O, I, kh, kw). Returns NHWC (stacked NHWC)."""
    w = params["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    stacked = w.dim() == 5
    if stacked:
        n, b, h, wd, c = x.shape
        x = x.permute(1, 2, 3, 0, 4).reshape(b, h, wd, n * c)
        w = w.reshape((-1,) + w.shape[2:])
    kh, kw = w.shape[-2:]
    ph, pw = _same_pad(x.shape[1], kh, stride), _same_pad(x.shape[2], kw,
                                                          stride)
    xin = x.permute(0, 3, 1, 2)                      # channels_last view
    if ph[0] == ph[1] and pw[0] == pw[1]:
        y = F.conv2d(xin, w, stride=stride, padding=(ph[0], pw[0]),
                     groups=n if stacked else 1)
    else:
        xin = F.pad(xin, (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(xin, w, stride=stride, groups=n if stacked else 1)
    y = y.permute(0, 2, 3, 1)                        # NHWC
    if stacked:
        y = y.reshape(y.shape[:3] + (n, -1)).permute(3, 0, 1, 2, 4)
    return y.contiguous()
