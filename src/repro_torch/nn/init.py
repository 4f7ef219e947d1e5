"""Parameter initializers with the JAX package's fan rules.

Random draws come from an explicit ``torch.Generator``; the numbers differ
from ``jax.random``'s, the distributions match. Shapes follow JAX's layout
(``(kh, kw, in, out)`` for a conv kernel), so the fans are computed the same
way; the layers transpose to their own storage layout afterwards.
"""
from __future__ import annotations

import math

import torch


def _fans(shape, in_axis=-2, out_axis=-1):
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = 1
    for i, s in enumerate(shape):
        if i not in (in_axis % len(shape), out_axis % len(shape)):
            receptive *= s
    return shape[in_axis] * receptive, shape[out_axis] * receptive


def _device(gen):
    return None if gen is None else gen.device


# Leaves of more elements are drawn in slices (see _normal).
SLICED_DRAW = 2 ** 30
_SLICE = 2 ** 26


def _normal(gen, shape, std, dtype):
    """Drawn on the generator's device: a CUDA generator makes the weights
    on the card, with no host draw and copy.

    A leaf of more than ``SLICED_DRAW`` elements (one of llama4-maverick's
    expert stacks holds 5.4e9) is drawn in contiguous slices of
    ``_SLICE`` elements along its leading axes, each straight into a
    preallocated leaf of ``dtype``: the temporaries
    are one f32 slice, not two f32 copies of the leaf. Its numbers differ
    from one whole draw's; every smaller leaf draws as one call."""
    dev = _device(gen)
    n = math.prod(shape)
    if n <= SLICED_DRAW:
        return (torch.randn(shape, generator=gen, device=dev)
                * std).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=dev)
    flat = out.view(-1)
    buf = torch.empty(min(n, _SLICE), dtype=torch.float32, device=dev)
    for lo in range(0, n, _SLICE):
        part = buf[:min(_SLICE, n - lo)]
        torch.randn(part.shape, generator=gen, out=part)
        flat[lo:lo + part.numel()].copy_(part.mul_(std))
    return out


def lecun_normal(gen, shape, dtype=torch.float32, in_axis=-2, out_axis=-1):
    fan_in, _ = _fans(shape, in_axis, out_axis)
    return _normal(gen, shape, math.sqrt(1.0 / max(fan_in, 1)), dtype)


def he_normal(gen, shape, dtype=torch.float32, in_axis=-2, out_axis=-1):
    fan_in, _ = _fans(shape, in_axis, out_axis)
    return _normal(gen, shape, math.sqrt(2.0 / max(fan_in, 1)), dtype)


def normal_init(gen, shape, stddev=0.02, dtype=torch.float32):
    return _normal(gen, shape, stddev, dtype)


def zeros(gen, shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=_device(gen))


def ones(gen, shape, dtype=torch.float32):
    return torch.ones(shape, dtype=dtype, device=_device(gen))


def uniform_scaling(gen, shape, scale=1.0, dtype=torch.float32):
    """U(-lim, lim) with ``lim = scale * sqrt(3 / fan_in)``."""
    fan_in, _ = _fans(shape)
    lim = scale * math.sqrt(3.0 / max(fan_in, 1))
    u = torch.rand(shape, generator=gen, device=_device(gen))
    return ((2.0 * u - 1.0) * lim).to(dtype)
