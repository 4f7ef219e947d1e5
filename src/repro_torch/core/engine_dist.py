"""The sharded SFPL epoch on ``torch.distributed`` (the paper's schemes at
fleet scale).

``engine.sfpl_epoch`` simulates every client on one device. Here the
clients are split over the ranks of a 1-D process group (a ``DataGroup``
placement): rank ``r`` holds the ``r``-th contiguous block of clients'
params, BN state and optimizer state and their data, the server state is
replicated, and the collector shuffle is ONE ``all_to_all`` per exchange
direction under a per-step route plan (``round.MeshAllToAll``). The step
body is the single-device one, ``round.sfpl_round``; the placement makes
its pool-wide reductions (server BN moments, the loss's valid count, the
server gradients, FedAvg) run over the group.

Collector modes: "balanced" (drop-free block permutations, per flush group
when ``alpha < 1``, aligned to the ranks' slabs) and "uniform" (the
paper's uniform shuffle, slack probed by ``uniform_auto_slack`` and the
capacity check on). Collector pipelines: "sync" (one blocking exchange a
step) and "double_buffered" (``round.StreamingAllToAll``: one exchange a
flush group, issued while the next group's client forward computes, the
last drained after the loop; over each group's own slice of ranks when
the layout allows sub-mesh routing). ``pods`` lays the ranks out as the
JAX package's 2-D ``("pod", "data")`` mesh: pod-major, each pod's ranks a
subgroup of their own.

SFLv2 (``sflv2_epoch_sharded``) keeps its sequential visitation; each
visited client's batch is split over the ranks instead.

Process groups: gloo on the CPU, NCCL on the card (one rank per card).
``init_data_group`` reads ``torchrun``'s environment, or takes a store
path, or runs at world size 1 on an in-process store.
"""
from __future__ import annotations

import datetime
import os

import torch

from repro_torch.core import collector as C
from repro_torch.core import round as RD
from repro_torch.core.collector_dist import (group_fits_slabs,
                                             submesh_slice_size)
from repro_torch.core.wire import resolve_wire_dtype
from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def init_data_group(device=None, *, store=None, rank=None, world_size=None,
                    pods=None, timeout_s=300):
    """Join (or start) the default process group and return its
    ``DataGroup`` placement. Backend: NCCL when ``device`` is CUDA (the
    default; raises without CUDA), gloo on the CPU.

    Rendezvous, in order: an already initialised default group; the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``);
    a ``torch.distributed.FileStore`` at the path ``store`` with ``rank``
    and ``world_size``; else world size 1 on an in-process ``HashStore``.
    On CUDA the rank's card is ``LOCAL_RANK`` (else 0) and becomes the
    current device.

    ``pods`` (a divisor of the world size) makes the placement the 2-D
    pod layout (``make_pod_layout``)."""
    import torch.distributed as dist
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dev.index
                                                 or 0)))
    created = not dist.is_initialized()
    if created:
        timeout = datetime.timedelta(seconds=timeout_s)
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ \
                and "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://",
                                    timeout=timeout)
        elif store is not None:
            if rank is None or world_size is None:
                raise ValueError("a store path needs rank and world_size")
            dist.init_process_group(
                backend, store=dist.FileStore(str(store), world_size),
                rank=rank, world_size=world_size, timeout=timeout)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1, timeout=timeout)
    group = RD.DataGroup(group=None, rank=dist.get_rank(),
                         world=dist.get_world_size())
    if pods is None:
        return group
    try:
        return make_pod_layout(group, pods)
    except ValueError:
        if created:             # leave no half-made group behind
            close_data_group()
        raise


def make_pod_layout(group, pods):
    """``group`` as the 2-D ``(pods, world // pods)`` pod-major layout,
    the JAX package's ``make_data_mesh(world, pods=pods)``: the collector
    runs over all ranks in rank order (the flattened ``("pod", "data")``
    shard index), and each pod's consecutive ranks form a subgroup (made
    here, by every rank, for every pod) that a pod-local sub-mesh slice
    runs over.

    >>> make_pod_layout(RD.DataGroup(None, 0, 4), 3)
    Traceback (most recent call last):
        ...
    ValueError: pods=3 must be >= 1 and divide the world size 4 (each \
pod holds an equal contiguous slice of the ranks)
    """
    if pods < 1 or group.world % pods:
        raise ValueError(
            f"pods={pods} must be >= 1 and divide the world size "
            f"{group.world} (each pod holds an equal contiguous slice of "
            f"the ranks)")
    out = RD.DataGroup(group=group.group, rank=group.rank,
                       world=group.world, pods=pods)
    out.slice_group(group.world // pods)
    return out


def close_data_group():
    """Leave the default process group, if one is up, and forget the
    subgroups made over it."""
    import torch.distributed as dist
    RD.clear_subgroups()
    if dist.is_initialized():
        dist.destroy_process_group()


def _world_size():
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def check_sfpl_layout(num_clients, batch_size, n_shards, *, alpha=1.0,
                      collector_mode="balanced", collector_pipeline="sync",
                      collector_submesh=None, pods=None, participation=None,
                      wire_dtype=None, wire_dtype_bwd=None):
    """Eager validation of the sharded SFPL layout; raises ``ValueError``
    with an actionable message before any device work.

    Clients divide evenly over the shards. In balanced mode every flush
    group of the ``alpha`` threshold covers whole shard slabs (so the
    grouped permutation never crosses a slab mid-group) or lives inside
    one (no exchange), and a multi-shard group's shard count divides the
    slab. Uniform mode needs no alignment. The ``double_buffered``
    pipeline also needs every flush group's row count divisible by the
    shard count (the fallback exchanges each group over every shard)
    unless the layout qualifies for sub-mesh routing
    (``collector_submesh`` not ``False``, balanced mode,
    ``collector_dist.submesh_slice_size``); ``collector_submesh=True``
    demands that it qualifies. ``pods`` must divide ``n_shards``, and then
    a sub-mesh slice must also stay inside one pod (the whole mesh, or a
    divisor of the shards a pod). ``participation`` and the wire names
    are checked too.

    >>> check_sfpl_layout(8, 8, 8, alpha=0.5)
    [32, 32]
    >>> check_sfpl_layout(8, 8, 8, wire_dtype="int4")  # doctest: +ELLIPSIS
    Traceback (most recent call last):
        ...
    ValueError: unknown wire_dtype 'int4': expected one of ...
    >>> check_sfpl_layout(8, 8, 8, alpha=0.25, collector_submesh=True,
    ...                   collector_pipeline="double_buffered")
    [16, 16, 16, 16]
    >>> check_sfpl_layout(8, 8, 4, alpha=0.5, pods=4,
    ...                   collector_submesh=True,
    ...                   collector_pipeline="double_buffered")
    Traceback (most recent call last):
        ...
    ValueError: collector_submesh=True needs collector_mode='balanced' \
and every flush group covering the same number of whole shard slabs, \
with the slab divisible by that span — pod-local (the whole mesh, or \
dividing the 1 shards per pod) when pods=4; got mode='balanced', group \
sizes [32, 32] over 4 shards (num_clients=8, batch_size=8, alpha=0.5)

    Returns the flush groups' row counts."""
    resolve_wire_dtype(wire_dtype)
    resolve_wire_dtype(wire_dtype_bwd)
    if collector_pipeline not in ("sync", "double_buffered"):
        raise ValueError(f"unknown collector pipeline {collector_pipeline!r}"
                         f": expected 'sync' or 'double_buffered'")
    if collector_mode not in ("balanced", "uniform"):
        raise ValueError(f"unknown collector mode {collector_mode!r}: "
                         f"expected 'balanced' or 'uniform'")
    if num_clients % n_shards:
        raise ValueError(f"num_clients={num_clients} must divide evenly "
                         f"over {n_shards} shards")
    if participation is not None:
        C.check_participation(num_clients, participation, alpha=alpha)
    if pods is not None and (pods < 1 or n_shards % pods):
        raise ValueError(
            f"pods={pods} must be >= 1 and divide n_shards={n_shards} "
            f"(each pod holds an equal contiguous slice of the flattened "
            f"shard axis)")
    n_pool = num_clients * batch_size
    b = n_pool // n_shards
    rows = [c * batch_size for c in C.flush_group_sizes(num_clients, alpha)]
    if collector_pipeline == "double_buffered":
        slices = submesh_slice_size(n_pool, n_shards, rows)
        if (slices is not None and pods is not None and slices != n_shards
                and (n_shards // pods) % slices):
            slices = None        # a slice straddles a pod: the fallback
        sub_ok = (collector_submesh is not False
                  and collector_mode == "balanced" and slices is not None)
        if collector_submesh and not sub_ok:
            pod_req = ("" if pods is None else
                       f" — pod-local (the whole mesh, or dividing the "
                       f"{n_shards // pods} shards per pod) when "
                       f"pods={pods}")
            raise ValueError(
                f"collector_submesh=True needs collector_mode='balanced' "
                f"and every flush group covering the same number of whole "
                f"shard slabs, with the slab divisible by that span"
                f"{pod_req}; got mode={collector_mode!r}, group sizes "
                f"{rows} over {n_shards} shards (num_clients="
                f"{num_clients}, batch_size={batch_size}, alpha={alpha})")
        bad = [size for size in rows if size % n_shards]
        if bad and not sub_ok:
            raise ValueError(
                f"double_buffered collector needs every flush group's row "
                f"count divisible by the {n_shards} shards (each group is "
                f"row-sharded over the whole mesh for its own exchange), "
                f"or a balanced layout qualifying for sub-mesh routing; "
                f"got group sizes {rows} (num_clients={num_clients}, "
                f"batch_size={batch_size}, alpha={alpha})")
    if collector_mode != "balanced":
        return rows
    start = 0
    for size in rows:
        aligned, in_slab = group_fits_slabs(start, size, b)
        if not (aligned or in_slab):
            raise ValueError(
                f"flush group of {size} rows at offset {start} is not "
                f"aligned to the {b}-row shard slabs: choose alpha/"
                f"num_clients/batch_size so every flush group covers whole "
                f"shards, or use collector_mode='uniform' (num_clients="
                f"{num_clients}, batch_size={batch_size}, shards="
                f"{n_shards}, alpha={alpha})")
        s_g = size // b
        if aligned and s_g > 1 and b % s_g:
            raise ValueError(
                f"balanced exchange needs the {b}-row shard slab divisible "
                f"by the {s_g} shards each flush group spans "
                f"(num_clients={num_clients}, batch_size={batch_size}, "
                f"shards={n_shards}, alpha={alpha})")
        start += size
    return rows


def fit_shards(num_clients, batch_size, *, scheme="sfpl", alpha=1.0,
               collector_mode="balanced", collector_pipeline="sync",
               collector_submesh=None, pods=None, max_shards=None,
               participation=None, wire_dtype=None, wire_dtype_bwd=None):
    """Largest shard count, up to ``max_shards`` (default: the process
    group's world size, 1 without one), that the layout supports: for
    SFLv2 one that divides ``batch_size``; with ``pods`` only multiples
    of it. The participation mask and the wire names are checked once up
    front, so a bad one raises instead of being swallowed by the
    search."""
    resolve_wire_dtype(wire_dtype)
    resolve_wire_dtype(wire_dtype_bwd)
    if participation is not None:
        C.check_participation(num_clients, participation, alpha=alpha)
    for s in range(max_shards or _world_size(), 0, -1):
        if pods is not None and s % pods:
            continue
        if scheme == "sflv2":
            if batch_size % s == 0:
                return s
            continue
        try:
            check_sfpl_layout(num_clients, batch_size, s, alpha=alpha,
                              collector_mode=collector_mode,
                              collector_pipeline=collector_pipeline,
                              collector_submesh=collector_submesh, pods=pods)
            return s
        except ValueError:
            continue
    # one shard a pod, or one shard
    return pods if pods else 1


_CLIENT_KEYS = ("cp", "cbn", "copt")


def shard_dcml_state(st, group):
    """This rank's share of an ``init_dcml_state`` tree: the client-stacked
    leaves cut to its block of clients, the server leaves as they are."""
    return dict(st, **{k: tree_map(group.local, st[k])
                       for k in _CLIENT_KEYS})


def shard_client_data(data, group):
    """This rank's block of the per-client set {"x": (N, n, ...),
    "y": (N, n)}."""
    return tree_map(group.local, data)


def gather_clients(st, group):
    """Inverse of :func:`shard_dcml_state`: every rank's client blocks,
    concatenated in rank order (an all-gather), beside the server leaves."""
    if group.world == 1:
        return st
    import torch.distributed as dist

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(group.world)]
        dist.all_gather(parts, t.contiguous(), group=group.group)
        return torch.cat(parts)
    return dict(st, **{k: tree_map(gather, st[k]) for k in _CLIENT_KEYS})


def sfpl_epoch_sharded(gen, st, data, split, opt_c, opt_s, *, group,
                       num_clients, batch_size, bn_mode="cmsd", alpha=1.0,
                       use_kernel=None, slack=None, check_capacity=False,
                       collector_mode="balanced", collector_pipeline="sync",
                       stream_slack=None, collector_submesh=None,
                       participation=None, wire_dtype=None,
                       wire_dtype_bwd=None, device=None):
    """Sharded counterpart of ``engine.sfpl_epoch``.

    ``group`` is the ``DataGroup`` (``init_data_group``); ``st`` is this
    rank's share of an ``init_dcml_state`` tree (``shard_dcml_state``) and
    ``data`` its block of the per-client set (``shard_client_data``);
    ``num_clients`` counts the clients of every rank. ``gen`` draws the
    replicated per-step permutations: seed it alike on every rank. Returns
    ``(st, losses)``, ``losses`` (n // batch_size,) the global loss.

    ``alpha < 1`` runs per-flush-group balanced permutations aligned to
    the slabs; ``collector_mode="uniform"`` the uniform shuffle with
    probed slack. ``use_kernel=None`` runs the float gathers through the
    K4/K5 kernels on CUDA. ``wire_dtype`` / ``wire_dtype_bwd`` narrow the
    exchange payloads (``core.wire``); the per-row f32 scales ride the
    same collective as packed payload columns.

    ``collector_pipeline="double_buffered"`` streams the collector
    (``round.StreamingAllToAll``): one exchange a flush group, issued
    while the next group's client forward computes, the last drained
    after the loop; the losses equal the sync path's. ``collector_submesh``
    (``None``: on when the balanced layout qualifies; ``True`` demands
    it; ``False`` forces the whole-group fallback) confines each group's
    exchange to its own slice of ranks; ``stream_slack`` overrides the
    fallback's probed slack. A ``group`` with ``pods`` (``init_data_group
    (pods=)``) keeps sub-mesh slices inside a pod."""
    part_host = C.check_participation(num_clients, participation,
                                      alpha=alpha)
    check_sfpl_layout(num_clients, batch_size, group.world, alpha=alpha,
                      collector_mode=collector_mode,
                      collector_pipeline=collector_pipeline,
                      collector_submesh=collector_submesh,
                      pods=group.pods,
                      participation=part_host, wire_dtype=wire_dtype,
                      wire_dtype_bwd=wire_dtype_bwd)
    collector = group.collector(
        num_clients, alpha=alpha, mode=collector_mode, slack=slack,
        use_kernel=use_kernel, check_capacity=check_capacity,
        pipeline=collector_pipeline, stream_slack=stream_slack,
        submesh=collector_submesh, wire_dtype=wire_dtype,
        wire_dtype_bwd=wire_dtype_bwd)
    return RD.sfpl_round(gen, st, data, split, opt_c, opt_s,
                         num_clients=num_clients, batch_size=batch_size,
                         bn_mode=bn_mode, collector=collector,
                         participation=participation, device=device)


def sflv2_epoch_sharded(gen, st, data, split, opt_c, opt_s, *, group,
                        num_clients, batch_size, aggregate_bn=True,
                        device=None):
    """Sharded counterpart of ``engine.sflv2_epoch``: the sequential
    client visitation is kept (every rank draws the same order from
    ``gen``: seed it alike), and each visited client's batch is split
    over ``group``'s ranks, the server stream running data parallel. The
    state and the data are replicated (the whole ``init_dcml_state``
    tree and per-client set on every rank); the BN moments and the loss
    cover the whole batch and the ranks' gradients are summed, so every
    rank ends with the same state. ``batch_size`` must divide over the
    ranks. Returns ``(st, losses)``, ``losses`` (N, n // batch_size) in
    visitation order."""
    if batch_size % group.world:
        raise ValueError(
            f"batch_size={batch_size} must divide evenly over "
            f"{group.world} shards to shard the SFLv2 server stream")
    return RD.sflv2_round(gen, st, data, split, opt_c, opt_s,
                          num_clients=num_clients, batch_size=batch_size,
                          aggregate_bn=aggregate_bn, placement=group,
                          device=device)
