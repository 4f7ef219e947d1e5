"""Plain PyTorch version of the per-row softmax cross-entropy sweeps."""
from __future__ import annotations

import torch


def math_dtype(dtype):
    """f32 for f32 and narrower logits (the kernel's working type); f64
    stays f64 so gradcheck can run on the plain path."""
    return torch.promote_types(dtype, torch.float32)


def xent_fwd(x, labels):
    """x: (R, V) logits; labels: (R,) int64 valid class ids. Returns per-row
    ``(nll, lse)`` in the working type: ``lse = m + log(sum(exp(x - m)))``
    with ``m`` the row max, and ``nll = lse - x[label]``."""
    x = x.to(math_dtype(x.dtype))
    m = x.max(dim=1).values
    lse = m + torch.log(torch.exp(x - m[:, None]).sum(dim=1))
    ll = x.gather(1, labels[:, None])[:, 0]
    return lse - ll, lse


def xent_bwd(x, labels, lse, g):
    """``(softmax(x) - onehot(label)) * g`` per row, with the softmax rebuilt
    from the saved ``lse``; returned in ``x.dtype``."""
    md = math_dtype(x.dtype)
    p = torch.exp(x.to(md) - lse[:, None])
    cols = torch.arange(x.shape[1], device=x.device)
    onehot = (cols[None, :] == labels[:, None]).to(md)
    return ((p - onehot) * g.to(md)[:, None]).to(x.dtype)
