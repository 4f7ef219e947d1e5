"""Dense and embedding layers, ``(in, out)`` weights as in the JAX package."""
from __future__ import annotations

import torch

from repro_torch.sharding.dtensor import (fsdp_gather, gather_rows,
                                          grad_like, is_dtensor, shard_start)
from repro_torch.nn.init import lecun_normal, normal_init, zeros


def dense_init(gen, in_dim, out_dim, *, use_bias=True, dtype=torch.float32,
               init=lecun_normal):
    p = {"w": init(gen, (in_dim, out_dim), dtype=dtype)}
    if use_bias:
        p["b"] = zeros(gen, (out_dim,), dtype=dtype)
    return p


def dense_apply(params, x, *, compute_dtype=None):
    """``x @ w (+ b)``. Mixed dtypes promote as in JAX: an f32 input on
    bf16 weights gives an f32 product (the xLSTM gate projections). On
    DTensors the weight's FSDP shards are gathered; a block that feeds
    one activation to several projections gathers its rows once before
    them (``sharding.dtensor.gather_rows``), which leaves this call's own
    gather a no-op."""
    w = fsdp_gather(params["w"])
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    elif x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = grad_like(gather_rows(x) @ w)
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
    x = _lookup(params["table"], ids)
    return x if compute_dtype is None else x.to(compute_dtype)


def _lookup(table, ids):
    """``table[ids]``. A DTensor table is read vocab-parallel: its FSDP
    shards are gathered, each device reads the ids that fall in its own
    rows of the vocab (zeros elsewhere), and the rows are summed over the
    vocab's shards (a pending sum, ``Partial``); the table's gradient is
    a pending sum over the ids' shards."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    table = fsdp_gather(table)
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    vocab = [m for m, p in enumerate(table.placements) if p.is_shard(0)]
    ids = ids.redistribute(mesh, [Replicate() if m in vocab else p
                                  for m, p in enumerate(ids.placements)])
    lo, rows = shard_start(mesh, vocab, table.shape[0])

    def read(t, i):
        j = i - lo
        hit = (j >= 0) & (j < rows)
        return t[j.clamp(0, rows - 1)] * hit[..., None].to(t.dtype)

    out_pl = [Partial() if m in vocab else p
              for m, p in enumerate(ids.placements)]
    grad_pl = tuple(Partial() if ids.placements[m].is_shard()
                    and not p.is_shard() else p
                    for m, p in enumerate(table.placements))
    return local_map(read, out_pl, in_placements=(
        tuple(table.placements), tuple(ids.placements)),
        in_grad_placements=(grad_pl, tuple(ids.placements)))(table, ids)


def embedding_attend(params, x, *, compute_dtype=None):
    """Tied unembedding: project features back to vocab logits."""
    t = grad_like(fsdp_gather(params["table"]))  # also read by the lookup
    if compute_dtype is not None:
        t = t.to(compute_dtype)
        x = x.to(compute_dtype)
    return x @ t.T
