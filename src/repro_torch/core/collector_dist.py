"""Algorithm 1's collector across processes: route plans and one
``all_to_all`` per exchange direction on ``torch.distributed``.

Each rank of a 1-D process group holds a contiguous ``b = n // S`` row
slab of the pooled smashed data (its own clients' rows). Because the
permutation is replicated (every rank draws it from a generator seeded
alike), the routing metadata is built once per permutation, identically
on every rank (``build_route_plans``): the O(n) scatter inverse, each
row's destination rank, its slot in the send bucket and its place on the
receive side. The exchange is then gather -> ONE ``all_to_all_single`` ->
gather: the plan's ``send_idx`` gathers local rows straight into bucket
layout (kernel K4a), the collective ships the ``(S, cap)`` buckets, and
``recv_idx`` gathers the received block into output order (K4b). No
positions or masks cross the wire.

Balanced and grouped-balanced permutations route exactly ``b / S_g`` rows
between the ranks of a flush group, so their plans are built at that
exact capacity (``exact_pair_cap``) with ``may_drop=False``: no slack
padding for one global flush, no overflow accounting, no pad row. Uniform
permutations are slack-buffered (``may_drop=True``): overflowing rows go
to an out-of-range slot, arrive as the zero pad row, and are counted in
the plan's replicated ``overflow``, which ``check_capacity`` turns into an
exception raised on every rank at the same point, before the collective,
so no rank is left waiting in it.

The backward exchange of ``plan_shuffle`` is the same exchange under the
backward plan (Algorithm 1's gradient de-shuffle), built from the same two
arrays as the forward one. With a narrow ``wire_dtype`` the smashed rows
cross as bf16 (a cast around the exchange) or as int8/fp8 rows with one
f32 scale per row bitcast into four trailing byte lanes of the same
payload; the fused kernels K5a/K5b quantize during the send gather and
dequantize during the receive gather. fp8 payloads cross the collective
as ``uint8`` (gloo does not take ``float8_e4m3fn``). Integer payloads
(the label pool) ship as they are, through the plain gather.

The streaming (double-buffered) collector splits the exchange into two
halves so client compute can run between them: ``plan_exchange_issue``
bucket-gathers a slab and starts ``all_to_all_single(async_op=True)``
(the in-flight slot holds the send and receive buffers and the work
handle until ``plan_exchange_complete`` waits on it and gathers the
received rows into output order). When every flush group covers the same
number ``S`` of whole rank slabs with ``b % S == 0``
(``submesh_slice_size``), each group's exchange is DENSE and confined to
its owning slice of ``S`` ranks (``build_submesh_route_plans``; the
collective runs over a subgroup of those ranks). Otherwise the streamed
fallback exchanges each group over every rank in fine slabs of ``n_g /
S`` rows, a layout no rank holds; ``relayout_counts`` and ``relayout``
move a group's rows between the ranks' home slabs and the fine slabs with
one ``all_to_all_single`` of computed split sizes each way.

>>> pair_capacity(64, 8, 1.0)        # slack-buffered: b/S + 1 per pair
2
>>> exact_pair_cap(64, 8)            # dense balanced: exactly b/S
1
>>> grouped_perm_slack(64, 8, [64])  # one global balanced flush
1.0
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.wire import (SCALE_BYTES, WIRE_DTYPES, is_quantized,
                                   resolve_wire_dtype, wire_itemsize)
from repro_torch.kernels.collector_permute.ops import inverse_permutation


def _randperm(gen, n):
    return torch.randperm(n, generator=gen)


def make_balanced_perm(gen, n, num_shards):
    """Permutation that sends exactly ``b / num_shards`` rows between every
    (src, dst) shard pair: shuffle within shards, exchange equal blocks,
    shuffle within shards again. Drawn from ``gen`` (a CPU
    ``torch.Generator``); ranks that seed it alike draw the same perm."""
    if n % num_shards:
        raise ValueError(f"n={n} does not split over {num_shards} shards")
    b = n // num_shards
    if b % num_shards:
        raise ValueError(f"shard slab {b} does not split into {num_shards} "
                         f"equal blocks")

    def shard_shuffle():
        return torch.cat([_randperm(gen, b) + i * b
                          for i in range(num_shards)])

    p1 = shard_shuffle()
    blk = b // num_shards
    src = torch.arange(n)
    shard, pos = src // b, src % b
    p2 = (pos // blk) * b + (pos % blk) + shard * blk
    p3 = shard_shuffle()
    return p1[p2[p3]]                    # out[i] = x[p1[p2[p3[i]]]]


def group_fits_slabs(start, size, b):
    """``(aligned, in_slab)``: whether a contiguous flush group of ``size``
    rows at ``start`` covers whole ``b``-row slabs or lives inside one."""
    aligned = start % b == 0 and size % b == 0
    in_slab = start // b == (start + size - 1) // b
    return aligned, in_slab


def make_grouped_balanced_perm(gen, n, num_shards, group_sizes):
    """Per-flush-group balanced permutations aligned to shard boundaries:
    rows never cross a group; a group spanning S_g whole slabs is a
    balanced exchange (``b / S_g`` rows per pair), a group inside one slab
    shuffles uniformly in place. One draw sequence from ``gen``, group by
    group."""
    if len(group_sizes) <= 1:
        return make_balanced_perm(gen, n, num_shards)
    b = n // num_shards
    parts, start = [], 0
    for size in group_sizes:
        aligned, in_slab = group_fits_slabs(start, size, b)
        if not (aligned or in_slab):
            raise ValueError(f"flush group of {size} rows at {start} "
                             f"straddles a {b}-row slab")
        if aligned and size // b > 1:
            sub = make_balanced_perm(gen, size, size // b)
        else:
            sub = _randperm(gen, size)
        parts.append(sub + start)
        start += size
    return torch.cat(parts)


def exact_pair_cap(n, num_shards, group_sizes=None):
    """Exact worst (src, dst) bucket load of a (grouped) balanced
    permutation: ``b / S_g`` for a group over S_g whole slabs, ``b`` for a
    group inside one slab.

    >>> exact_pair_cap(64, 8, [32, 32])
    2
    """
    b = n // num_shards
    sizes = list(group_sizes) if group_sizes else [n]
    return max((b // (size // b)) if size % b == 0 else b for size in sizes)


def grouped_perm_slack(n, num_shards, group_sizes):
    """Slack that sizes the buckets for a grouped balanced permutation (1.0
    for one global flush at ``b % S == 0``)."""
    b = n // num_shards
    return exact_pair_cap(n, num_shards, group_sizes) * num_shards / b


def pair_capacity(n, n_shards, slack):
    """Rows the exchange buffer holds per (src, dst) shard pair."""
    b = n // n_shards
    return int(b * slack) // n_shards + 1


def pair_load(perm, n_shards):
    """Host-side (src, dst) bucket-load matrix of ``out[i] = x[perm[i]]``
    with both arrays split into ``n_shards`` equal slabs."""
    perm = np.asarray(perm)
    n = perm.shape[0]
    if n % n_shards:
        raise ValueError(f"n={n} does not split over {n_shards} shards")
    b = n // n_shards
    load = np.zeros((n_shards, n_shards), np.int64)
    np.add.at(load, (perm // b, np.arange(n) // b), 1)
    return load


def max_pair_load(perm, n_shards):
    """Worst bucket load: a perm is drop-free iff this <= the capacity."""
    return int(pair_load(perm, n_shards).max())


def assert_pair_capacity(perm, n_shards, *, slack):
    """Host-side guard: raise before an exchange that would drop rows."""
    n = np.asarray(perm).shape[0]
    cap = pair_capacity(n, n_shards, slack)
    worst = max_pair_load(perm, n_shards)
    if worst > cap:
        raise ValueError(
            f"collector exchange would drop rows: max (src, dst) load "
            f"{worst} exceeds capacity {cap} (n={n}, shards={n_shards}, "
            f"slack={slack}); raise slack or use make_balanced_perm")


@functools.lru_cache(maxsize=None)
def _uniform_auto_slack_cached(n, num_shards, group_sizes, probes, seed,
                               margin):
    rng = np.random.default_rng(seed)
    sizes = list(group_sizes) if group_sizes else [n]
    worst = 0
    for _ in range(probes):
        parts, start = [], 0
        for size in sizes:
            parts.append(rng.permutation(size) + start)
            start += size
        worst = max(worst, max_pair_load(np.concatenate(parts), num_shards))
    b = n // num_shards
    return (worst + margin) * num_shards / b


def uniform_auto_slack(n, num_shards, group_sizes=None, *, probes=16,
                       seed=0, margin=1):
    """Exchange slack for uniform shuffles, probed as ``max_pair_load`` over
    ``probes`` numpy sample permutations (per flush group when given) plus
    ``margin`` rows. Empirical, so pair it with ``check_capacity``. The
    probes and their memo are the JAX package's, so the value is too."""
    key = tuple(group_sizes) if group_sizes is not None else None
    return _uniform_auto_slack_cached(n, num_shards, key, probes, seed,
                                      margin)


def submesh_slice_size(n, n_shards, group_sizes):
    """Ranks per owning slice when the grouped layout qualifies for the
    sub-mesh streaming exchange, else ``None``: every flush group covers
    the SAME number ``S`` of whole ``b = n // n_shards``-row slabs (group
    ``g`` owns ranks ``[g*S, (g+1)*S)``) and ``b % S == 0`` (exactly
    ``b/S`` rows per in-slice pair). One global flush qualifies with the
    whole group as its slice.

    >>> submesh_slice_size(64, 8, [16, 16, 16, 16])
    2
    >>> submesh_slice_size(64, 8, [64])
    8
    >>> submesh_slice_size(64, 8, [32, 16, 16]) is None
    True
    """
    b = n // n_shards
    sizes = list(group_sizes) if group_sizes else [n]
    if any(size % b for size in sizes):
        return None                     # a group straddles a slab boundary
    spans = {size // b for size in sizes}
    if len(spans) != 1:
        return None                     # slices of unequal sizes
    slice_size = spans.pop()
    if b % slice_size or n_shards % slice_size:
        return None
    return slice_size


def submesh_axis_groups(n_shards, slice_size):
    """The contiguous ``slice_size``-rank slices that partition the
    ``n_shards`` ranks: each flush group's collective runs within its
    slice."""
    return [list(range(j, j + slice_size))
            for j in range(0, n_shards, slice_size)]


def _np_balanced_perm(rng, n, num_shards):
    """Host-side numpy replica of ``make_balanced_perm``'s structure
    (shard shuffles around the equal-block exchange) for load probing."""
    b = n // num_shards

    def shard_shuffle():
        return np.concatenate([rng.permutation(b) + i * b
                               for i in range(num_shards)])

    p1 = shard_shuffle()
    blk = b // num_shards
    src = np.arange(n)
    shard = src // b
    pos = src % b
    p2 = (pos // blk) * b + (pos % blk) + shard * blk
    p3 = shard_shuffle()
    return p1[p2[p3]]


@functools.lru_cache(maxsize=None)
def _balanced_stream_slack_cached(n, num_shards, span, probes, seed, margin):
    rng = np.random.default_rng(seed)
    worst = 0
    for _ in range(probes):
        perm = (_np_balanced_perm(rng, n, span) if span > 1
                else rng.permutation(n))
        worst = max(worst, max_pair_load(perm, num_shards))
    b = n // num_shards
    # never above the capacity-safe slack = num_shards (cap = b + 1 per
    # pair holds any permutation of the group)
    return min((worst + margin) * num_shards / b, float(num_shards))


def balanced_stream_slack(n, num_shards, span, *, probes=16, seed=0,
                          margin=1):
    """Slack of the streamed whole-group fallback for one BALANCED flush
    group of ``n`` rows: ``max_pair_load`` probed over numpy draws of the
    group's permutation family (a balanced exchange over ``span`` blocks,
    or a uniform shuffle at ``span <= 1``) against the ``n //
    num_shards``-row fine slabs, plus ``margin`` rows, clamped at
    ``num_shards``. Empirical, so pair it with ``check_capacity``. The
    probes and their memo are the JAX package's, so the value is too."""
    return _balanced_stream_slack_cached(n, num_shards, span, probes, seed,
                                         margin)


def _raise_on_overflow(count):
    if count > 0:
        raise RuntimeError(
            f"collector exchange dropped {count} rows: per-pair bucket "
            f"capacity exceeded; raise slack or use make_balanced_perm")


# --------------------------------------------------------------------------
# route plans

@dataclasses.dataclass(frozen=True)
class RoutePlan:
    """Routing metadata of one exchange direction, identical on every rank.

      * ``send_idx``: ``(n_shards, n_shards * cap)`` int32; row ``s`` maps
        shard ``s``'s flattened (destination, slot) to a local source row.
        Slots no row occupies point at row 0 and are never read.
      * ``recv_idx``: ``(n_shards, b)`` int32; row ``d`` maps shard ``d``'s
        local output rows to the flattened (source, slot) of its received
        block. On ``may_drop`` plans a dropped row points at the zero pad
        row ``n_shards * cap``.
      * ``overflow``: the count of rows over capacity (a 0-d int32 tensor),
        ``None`` on dense plans.

    ``slice_size`` is ``None`` for a whole-group exchange; a sub-mesh plan
    (``build_submesh_route_plans``) sets it to its slice's rank count
    ``S``, its rows ``[g*S, (g+1)*S)`` of the index arrays hold the slice
    plan and its collective runs over those ``S`` ranks only.
    """
    send_idx: torch.Tensor
    recv_idx: torch.Tensor
    overflow: Optional[torch.Tensor]
    n: int
    n_shards: int
    cap: int
    may_drop: bool
    slice_size: Optional[int] = None

    @property
    def dense(self):
        shards = self.slice_size or self.n_shards
        return not self.may_drop and shards * self.cap == \
            self.n // self.n_shards


def inverse_permutation_scatter(perm):
    """O(n) scatter inverse in the plans' int32: ``inv[perm[i]] = i``."""
    return inverse_permutation(perm.to(torch.int32))


def _build_one_plan(out_pos, n_shards, cap, may_drop):
    """Plan of the exchange whose source row ``g`` lands at global output
    position ``out_pos[g]`` (the inverse of the permutation applied).
    O(n * n_shards), no sorts; the JAX package's construction, with the
    dropping scatters written as scatters into one spare column that is
    cut off afterwards."""
    n = out_pos.shape[0]
    b = n // n_shards
    dev = out_pos.device
    out_pos = out_pos.long()
    g = torch.arange(n, device=dev)
    src_shard, local_row = g // b, g % b
    dest = out_pos // b
    # rank of row g within its (src_shard, dest) bucket, ascending in g: a
    # per-slab running count of destinations (one-hot cumsum; the one-hot
    # by comparison, as F.one_hot checks its range with a host sync)
    oh = dest.reshape(n_shards, b, 1) == torch.arange(n_shards, device=dev)
    cum = torch.cumsum(oh, dim=1)
    rank = (torch.gather(cum, 2, dest.reshape(n_shards, b, 1)) - 1
            ).reshape(n)
    ok = rank < cap
    oob = n_shards * cap
    slot = torch.where(ok, dest * cap + rank, torch.full_like(rank, oob))
    send_idx = torch.zeros((n_shards, oob + 1), dtype=torch.int32,
                           device=dev)
    send_idx[src_shard, slot] = local_row.to(torch.int32)
    out_local = torch.where(ok, out_pos % b, torch.full_like(out_pos, b))
    recv_idx = torch.full((n_shards, b + 1), oob if may_drop else 0,
                          dtype=torch.int32, device=dev)
    recv_idx[dest, out_local] = (src_shard * cap + rank).to(torch.int32)
    overflow = (~ok).sum().to(torch.int32) if may_drop else None
    return RoutePlan(send_idx[:, :oob].contiguous(),
                     recv_idx[:, :b].contiguous(), overflow, int(n),
                     n_shards, int(cap), bool(may_drop))


def build_route_plan(perm, n_shards, *, cap, may_drop=True):
    """Forward plan of ``out[i] = x[perm[i]]``. ``may_drop=False`` asserts
    every (src, dst) load is <= ``cap`` (true by construction for
    (grouped-)balanced perms at ``exact_pair_cap``)."""
    return _build_one_plan(inverse_permutation_scatter(perm), n_shards,
                           cap, may_drop)


def build_route_plans(perm, n_shards, *, cap, may_drop=True):
    """(forward, backward) plans of a permutation from one O(n) inverse:
    the backward exchange applies the inverse permutation, whose inverse
    is ``perm`` itself. The inverse's load matrix is the forward's
    transpose, so one ``cap`` serves both."""
    fwd = _build_one_plan(inverse_permutation_scatter(perm), n_shards, cap,
                          may_drop)
    bwd = _build_one_plan(perm, n_shards, cap, may_drop)
    return fwd, bwd


def _embed_slice_plan(plan, slice_index, n_shards):
    """A slice-local dense plan (over ``S = plan.n_shards`` ranks) in
    ``(n_shards, b)`` index arrays at rows ``[slice_index * S,
    (slice_index + 1) * S)``; the other rows stay zero (those ranks take
    no part in the slice's collective)."""
    slice_size = plan.n_shards
    b = plan.recv_idx.shape[1]
    j0 = slice_index * slice_size

    def embed(idx):
        out = torch.zeros((n_shards, b), dtype=torch.int32,
                          device=idx.device)
        out[j0:j0 + slice_size] = idx
        return out
    return RoutePlan(embed(plan.send_idx), embed(plan.recv_idx), None,
                     n_shards * b, n_shards, plan.cap, False,
                     slice_size=slice_size)


def build_submesh_route_plans(sub_perm, slice_index, n_shards, slice_size):
    """(forward, backward) DENSE plans of flush group ``slice_index``'s
    ``(n_g,)`` sub-permutation (group-local rows, ``n_g = slice_size *
    b``), routed only over the group's own slice of ``slice_size`` ranks:
    exact capacity ``b / slice_size``, no overflow count, no pad row, and
    both plans from one O(n_g) inverse, as ``build_route_plans``."""
    n_g = sub_perm.shape[0]
    b = n_g // slice_size
    cap = b // slice_size
    fwd = _build_one_plan(inverse_permutation_scatter(sub_perm),
                          slice_size, cap, False)
    bwd = _build_one_plan(sub_perm, slice_size, cap, False)
    return (_embed_slice_plan(fwd, slice_index, n_shards),
            _embed_slice_plan(bwd, slice_index, n_shards))


def _plan_exchange_spec(plan):
    """(ranks in the collective, cap) of a plan's bucket block."""
    return (plan.slice_size or plan.n_shards), plan.cap


def plan_payload_bytes(plan, row_elems, itemsize, *, wire_dtype=None):
    """Wire bytes of ONE collective under a plan: each of the ``n_shards``
    ranks ships its ``(S, cap)`` bucket block of ``row_elems``-element
    rows (``S`` the plan's slice, else ``n_shards``), at ``itemsize``
    bytes per element, or at the wire's itemsize plus ``SCALE_BYTES`` per
    row for a quantized wire."""
    S, cap = _plan_exchange_spec(plan)
    rows = plan.n_shards * S * cap
    wire = resolve_wire_dtype(wire_dtype)
    if wire is None:
        return rows * row_elems * itemsize
    row_bytes = row_elems * wire_itemsize(wire)
    if is_quantized(wire):
        row_bytes += SCALE_BYTES
    return rows * row_bytes


# --------------------------------------------------------------------------
# plan-driven exchange: gather -> ONE all_to_all -> gather

def _resolve_wire(x_dtype, wire_dtype):
    """Effective wire of one payload, or ``None`` to ship it as it is: no
    wire asked for, a non-float payload (labels never quantize), or a
    wire the payload is already in."""
    wire = resolve_wire_dtype(wire_dtype)
    if wire is None or not x_dtype.is_floating_point:
        return None
    if WIRE_DTYPES[wire] == x_dtype:
        return None
    return wire


def _gather_rows(x, idx, *, use_kernel, bucket_shape=None):
    """Row gather ``x[idx]``; float rows through K4a (``bucket_shape``
    given, the send side) or K4b (the receive side) when ``use_kernel``."""
    if use_kernel and x.is_floating_point():
        from repro_torch.kernels.collector_permute.ops import (
            bucket_gather, unbucket_gather)
        if bucket_shape is not None:
            return bucket_gather(x, idx.reshape(bucket_shape))
        return unbucket_gather(x, idx)
    return x[idx]


def _quant_send_payload(x_loc, send_idx, S, cap, wire, use_kernel):
    """Send side of a quantized exchange: the quantize-gather of the local
    rows into bucket order, with each row's f32 scale bitcast into
    ``SCALE_LANES`` trailing byte columns: ``(S*cap, d + LANES)``, ONE
    wire-dtype operand (K5a writes it in place)."""
    from repro_torch.kernels.quant_permute import ops as Q, ref as QR
    from repro_torch.core.wire import pack_scales
    if use_kernel:
        return Q.quant_bucket_permute_packed(
            x_loc, send_idx.reshape(S, cap), wire_dtype=wire)
    q, scales = QR.quant_bucket_permute(x_loc.reshape(x_loc.shape[0], -1),
                                        send_idx, wire)
    return torch.cat([q, pack_scales(scales, wire)], dim=1)


def _dequant_recv_payload(flat, recv_idx, out_dtype, feat_shape,
                          use_kernel):
    """Receive side: the fused dequantize-gather of the flat ``(R, d +
    LANES)`` block into output order in the compute dtype (K5b reads the
    q view and the scale lanes in place). The pad row is all zero, so its
    scale is 0.0 and dropped rows come out as exact zeros."""
    from repro_torch.kernels.quant_permute import ops as Q, ref as QR
    from repro_torch.core.wire import SCALE_LANES, unpack_scales
    if use_kernel:
        out2 = Q.dequant_unbucket_permute_packed(flat, recv_idx,
                                                 out_dtype=out_dtype)
    else:
        d = flat.shape[1] - SCALE_LANES
        out2 = QR.dequant_unbucket_permute(flat[:, :d],
                                           unpack_scales(flat[:, d:]),
                                           recv_idx, out_dtype)
    return out2.reshape((recv_idx.shape[0],) + tuple(feat_shape))


def _all_to_all(send, group, S, cap, pad, async_op=False):
    """``all_to_all_single`` of a ``(S*cap, ...)`` bucket block: chunk
    ``s`` goes to rank ``s`` of ``group`` and the chunk from rank ``s``
    lands at rows ``[s*cap, (s+1)*cap)``. ``pad`` appends a zero row (the
    drop slot of slack-buffered plans) to the receive buffer itself, with
    no copy. Byte-sized floats cross as ``uint8``. With ``async_op``
    returns ``(recv, work)``: ``recv`` is valid after ``work.wait()``."""
    import torch.distributed as dist
    send = send.contiguous()
    recv = torch.empty((S * cap + pad,) + tuple(send.shape[1:]),
                       dtype=send.dtype, device=send.device)
    if pad:
        recv[S * cap:].zero_()
    body = recv[:S * cap]
    if send.dtype == torch.float8_e4m3fn:
        body, send = body.view(torch.uint8), send.view(torch.uint8)
    work = dist.all_to_all_single(body, send, group=group,
                                  async_op=async_op)
    return (recv, work) if async_op else recv


def plan_exchange(x, plan, *, group, rank, use_kernel=False,
                  check_capacity=False, wire_dtype=None):
    """One full exchange of this rank's ``(b, ...)`` rows under a route
    plan: bucket-gather into send layout, ONE ``all_to_all_single``,
    gather into output order. Not differentiable on its own
    (``plan_shuffle`` supplies the gradient).

    ``check_capacity`` raises on a plan whose replicated ``overflow`` is
    positive, on every rank alike and before the collective. A quantized
    ``wire_dtype`` swaps the two gathers for K5a/K5b with the scales
    packed into the payload; bf16 is a cast around the exchange; integer
    payloads ship as they are."""
    S, cap = _plan_exchange_spec(plan)
    if check_capacity and plan.overflow is not None:
        _raise_on_overflow(int(plan.overflow))
    wire = _resolve_wire(x.dtype, wire_dtype)
    send_idx, recv_idx = plan.send_idx[rank], plan.recv_idx[rank]
    pad = int(plan.may_drop)
    if wire is not None and is_quantized(wire):
        payload = _quant_send_payload(x, send_idx, S, cap, wire,
                                      use_kernel)
        flat = _all_to_all(payload, group, S, cap, pad)
        return _dequant_recv_payload(flat, recv_idx, x.dtype, x.shape[1:],
                                     use_kernel)
    x_w = x.to(WIRE_DTYPES[wire]) if wire else x
    bucket = _gather_rows(x_w, send_idx, use_kernel=use_kernel,
                          bucket_shape=(S, cap))
    flat = _all_to_all(bucket, group, S, cap, pad)
    out = _gather_rows(flat, recv_idx, use_kernel=use_kernel)
    return out.to(x.dtype) if wire else out


class Slot(NamedTuple):
    """An issued exchange in flight: the receive buffer (valid after the
    work handle's ``wait()``), the plan, the wire context ``None`` or
    ``(wire name, compute dtype, feature shape)``, the work handle, the
    send buffer (kept alive until the wait) and whether to check the
    plan's overflow count on completion."""
    recv: torch.Tensor
    plan: RoutePlan
    ctx: Optional[tuple]
    work: object
    send: torch.Tensor
    check: bool


def plan_exchange_issue(x, plan, *, group, rank, use_kernel=False,
                        check_capacity=False, wire_dtype=None):
    """First half of the split exchange: bucket-gather this rank's rows
    ``x`` by destination (K4a, or K5a's quantize-gather into the packed
    wire payload) and start ``all_to_all_single(async_op=True)``. Returns
    the in-flight ``Slot``; nothing in it depends on later compute, so
    whatever runs before ``plan_exchange_complete`` overlaps the
    collective. Under NCCL the wait orders the current stream after the
    communication stream: no host synchronisation on the path. A
    sub-mesh plan's ``group`` is its slice's subgroup; ``rank`` is this
    rank's index in the whole group either way (the plan's rows are)."""
    S, cap = _plan_exchange_spec(plan)
    wire = _resolve_wire(x.dtype, wire_dtype)
    ctx = None if wire is None else (wire, x.dtype, tuple(x.shape[1:]))
    send_idx = plan.send_idx[rank]
    if wire is not None and is_quantized(wire):
        send = _quant_send_payload(x, send_idx, S, cap, wire,
                                   use_kernel).contiguous()
    else:
        x_w = x.to(WIRE_DTYPES[wire]) if wire else x
        send = _gather_rows(x_w, send_idx, use_kernel=use_kernel,
                            bucket_shape=(S, cap)).contiguous()
    recv, work = _all_to_all(send, group, S, cap, int(plan.may_drop),
                             async_op=True)
    return Slot(recv, plan, ctx, work, send,
                check_capacity and plan.overflow is not None)


def plan_exchange_complete(slot, *, rank, use_kernel=False):
    """Second half: wait on the slot's collective, raise on a positive
    overflow count (every rank alike: the count is replicated), and
    gather the received block into this rank's output order, undoing the
    wire format (a cast back, or K5b's dequantize-gather) into the
    compute dtype it was issued from."""
    slot.work.wait()
    if slot.check:
        _raise_on_overflow(int(slot.plan.overflow))
    recv_idx = slot.plan.recv_idx[rank]
    wire = None if slot.ctx is None else slot.ctx[0]
    if wire is not None and is_quantized(wire):
        return _dequant_recv_payload(slot.recv, recv_idx, slot.ctx[1],
                                     slot.ctx[2], use_kernel)
    out = _gather_rows(slot.recv, recv_idx, use_kernel=use_kernel)
    return out.to(slot.ctx[1]) if wire else out


def relayout_counts(start, stop, b_home, world):
    """Rows of the pool range ``[start, stop)`` (one flush group) that
    rank ``h`` holds in its home slab ``[h*b_home, (h+1)*b_home)`` AND
    rank ``s`` holds in the group's fine slab ``[start + s*b_fine, start +
    (s+1)*b_fine)``, ``b_fine = (stop - start) / world``: ``counts[h][s]``
    (host ints, identical on every rank)."""
    b_fine = (stop - start) // world
    counts = []
    for h in range(world):
        lo, hi = max(start, h * b_home), min(stop, (h + 1) * b_home)
        counts.append([max(0, min(hi, start + (s + 1) * b_fine)
                           - max(lo, start + s * b_fine))
                       for s in range(world)])
    return counts


def relayout(x, counts, *, group, rank, reverse=False):
    """Move one flush group's rows between the ranks' home slabs and the
    group's fine slabs (``relayout_counts``) with one
    ``all_to_all_single`` of computed split sizes. Forward: ``x`` is this
    rank's home rows of the group (in pool order) and the result its fine
    slab; ``reverse`` goes back. Rows stay in pool order both ways, since
    both layouts cut the group into ascending ranges. When no row changes
    rank (the counts are diagonal) no collective runs."""
    import torch.distributed as dist
    world = len(counts)
    if all(counts[h][s] == 0 for h in range(world) for s in range(world)
           if h != s):
        return x
    send = [counts[rank][s] for s in range(world)]
    recv = [counts[h][rank] for h in range(world)]
    if reverse:
        send, recv = recv, send
    out = torch.empty((sum(recv),) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_to_all_single(out, x.contiguous(), output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    return out


class _PlanShuffle(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plans, opts):
        ctx.bwd_plan, ctx.opts = plans[1], opts
        return plan_exchange(x, plans[0], group=opts["group"],
                             rank=opts["rank"],
                             use_kernel=opts["use_kernel"],
                             check_capacity=opts["check_capacity"],
                             wire_dtype=opts["wire_dtype"])

    @staticmethod
    def backward(ctx, g):
        o = ctx.opts
        # exact for drop-free plans; under overflow the forward already
        # lost rows (see check_capacity)
        gx = plan_exchange(g.contiguous(), ctx.bwd_plan, group=o["group"],
                           rank=o["rank"], use_kernel=o["use_kernel"],
                           wire_dtype=o["wire_dtype_bwd"])
        return gx, None, None


def plan_shuffle(x, plans, *, group, rank, use_kernel=False,
                 check_capacity=False, wire_dtype=None, wire_dtype_bwd=None):
    """Differentiable plan exchange: ``plans`` is the ``(forward,
    backward)`` pair from ``build_route_plans``. The gradient is the plan
    exchange under the backward plan (Algorithm 1's de-shuffle), one more
    ``all_to_all`` that re-derives no routing. ``wire_dtype`` narrows the
    forward payload, with gradients straight-through with respect to the
    dequantized values; the backward exchange is exact unless
    ``wire_dtype_bwd`` narrows the gradient rows too."""
    opts = dict(group=group, rank=rank, use_kernel=use_kernel,
                check_capacity=check_capacity, wire_dtype=wire_dtype,
                wire_dtype_bwd=wire_dtype_bwd)
    return _PlanShuffle.apply(x, plans, opts)
