"""Dense and embedding layers, ``(in, out)`` weights as in the JAX package."""
from __future__ import annotations

import torch

from repro_torch.nn.init import lecun_normal, normal_init, zeros


def dense_init(gen, in_dim, out_dim, *, use_bias=True, dtype=torch.float32,
               init=lecun_normal):
    p = {"w": init(gen, (in_dim, out_dim), dtype=dtype)}
    if use_bias:
        p["b"] = zeros(gen, (out_dim,), dtype=dtype)
    return p


def dense_apply(params, x, *, compute_dtype=None):
    """``x @ w (+ b)``. Mixed dtypes promote as in JAX: an f32 input on
    bf16 weights gives an f32 product (the xLSTM gate projections)."""
    w = params["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    elif x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


def embedding_init(gen, vocab, dim, *, dtype=torch.float32, stddev=0.02):
    return {"table": normal_init(gen, (vocab, dim), stddev=stddev,
                                 dtype=dtype)}


def embedding_apply(params, ids, *, compute_dtype=None):
    """Rows ``ids`` of the table. The rows are gathered before the cast:
    a gather then a cast equals a cast then a gather bit for bit, and it
    casts (B, S, d) values instead of the whole (vocab, d) table."""
    x = params["table"][ids]
    return x if compute_dtype is None else x.to(compute_dtype)


def embedding_attend(params, x, *, compute_dtype=None):
    """Tied unembedding: project features back to vocab logits."""
    t = params["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
        x = x.to(compute_dtype)
    return x @ t.T
