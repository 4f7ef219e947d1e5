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


def bn_moments(x, scale, bias, run_mean, run_var, run_count, *, momentum,
               eps, training):
    """x: (G, rows, C); scale, bias, run_mean, run_var: (G, C); run_count:
    (G,). The moments over the rows in f32 (or f64 for f64 input), the
    fold and the running update, as the kernel's launcher returns them:
    ``stats`` (5, G, C) mean, biased var, ``a``, ``b``, ``rstd``, and the
    new running ``(mean, var, count)`` when ``training``, else ``None``.
    Each is the plain BatchNorm's own expression, in its order."""
    md = math_dtype(x.dtype)
    var, mean = torch.var_mean(x.to(md), dim=1, correction=0)
    sd = torch.sqrt(var + eps)
    a = scale.to(md) / sd
    stats = torch.stack([mean, var, a, bias.to(md) - mean * a, 1.0 / sd])
    if not training:
        return stats, None
    return stats, (momentum * run_mean + (1 - momentum) * mean,
                   momentum * run_var + (1 - momentum) * var,
                   run_count + 1.0)


def bn_grad(gy, x, stats, *, relu):
    """The backward of ``relu?(x * a + b)`` with ``a``, ``b`` folded from
    the batch moments of x (G, rows, C), through the moments too: with
    ``gm = gy`` where K2's ``y > 0`` (recomputed from x, a, b), ``N`` rows
    and ``d = x - mean``, ``dx = a * ((gm - sum(gm) / N) - d * rstd**2 *
    (sum(gm * d) / N))`` in f32, stored in ``x.dtype``; ``dscale = rstd *
    sum(gm * d)``, ``dbias = sum(gm)`` (G, C)."""
    md = math_dtype(x.dtype)
    mean, _, a, b, rstd = (s[:, None, :] for s in stats.to(md))
    gm = gy.to(md)
    if relu:
        y = bn_act(x, a[:, 0], b[:, 0], relu=True)
        gm = torch.where(y > 0, gm, torch.zeros((), dtype=md,
                                                device=gm.device))
    d = x.to(md) - mean
    sg, sgd = gm.sum(dim=1), (gm * d).sum(dim=1)
    n = x.shape[1]
    k_mean, k_var = sg / n, rstd[:, 0] * rstd[:, 0] * (sgd / n)
    dx = a * ((gm - k_mean[:, None]) - d * k_var[:, None])
    return dx.to(x.dtype), rstd[:, 0] * sgd, sg
