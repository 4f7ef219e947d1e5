"""Dense layer, ``(in, out)`` weights as in the JAX package."""
from __future__ import annotations

import torch

from repro_torch.nn.init import lecun_normal, zeros


def dense_init(gen, in_dim, out_dim, *, dtype=torch.float32):
    return {"w": lecun_normal(gen, (in_dim, out_dim), dtype=dtype),
            "b": zeros(gen, (out_dim,), dtype=dtype)}


def dense_apply(params, x, *, compute_dtype=None):
    w = params["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    return x @ w + params["b"].to(x.dtype)
