"""The DCML round engine: SFPL (Algorithm 1 + 2) and SFLv2.

One ``sfpl_round`` serves every placement:

  * a placement says where state and batches live: ``SingleDevice``, or a
    ``DataGroup`` of ``torch.distributed`` ranks, each holding a
    contiguous block of clients (and so a contiguous slab of the pool)
    with the server state replicated;
  * a collector strategy says how Algorithm 1's collect-shuffle-scatter
    runs: ``DenseTake`` (a dense gather on one device, or the
    ``collector_permute`` kernel), ``MeshAllToAll`` (one ``all_to_all``
    per direction under a per-step route plan, with the bucket kernels
    K4a/K4b and, on a quantized wire, K5a/K5b) or ``StreamingAllToAll``
    (the same exchange per flush group, split into issue and complete
    halves with the next group's client forward between them and the last
    group drained after the loop: the paper's threshold-queue collector
    as a two-slot software pipeline).

The JAX round is SPMD, so its reductions over the whole pool come free.
Here a ``DataGroup`` of several ranks makes them explicit, and on one
device or one rank each is the identity (so that path is unchanged):

  * the server BatchNorm moments over the global pool (a differentiable
    all-reduce, so the backward matches too; client BN stays local);
  * the loss normalised by the global valid count, with the server
    gradients summed across ranks before the optimizer step;
  * FedAvg and the BN-state aggregation over all clients.

Gradient de-shuffling is never hand-derived on the sync collectors: the
server loss is taken as a function of the PRE-shuffle pool, whose rows
require grad, and their permutes are differentiable, so autograd routes
the activation gradients back (the inverse permutation, or the exchange
under the route plan's backward half). ``StreamingAllToAll`` assembles
the shuffled pool outside the loss (the forwards interleave with the
exchanges), so it routes explicitly: ``route_back`` is the same exchange
under the backward plans.

Shape contract: the pool is client-major, ``(num_clients * batch_size,
...)``, row ``c * batch_size + j`` being sample ``j`` of client ``c``;
``make_perm`` returns the replicated ``(n,)`` permutation of the whole
pool, which never crosses flush-group boundaries, and each rank permutes
its own slab.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import collector as C
from repro_torch.core.bn_policy import aggregate_bn_state, fedavg
from repro_torch.core.collector_dist import (
    _resolve_wire, balanced_stream_slack, build_route_plans,
    build_submesh_route_plans, exact_pair_cap, make_grouped_balanced_perm,
    pair_capacity, plan_exchange, plan_exchange_complete,
    plan_exchange_issue, plan_payload_bytes, plan_shuffle, relayout,
    relayout_counts, submesh_axis_groups, submesh_slice_size,
    uniform_auto_slack)
from repro_torch.device import resolve_device
from repro_torch.trace import COUNTERS, span, spanned
from repro_torch.tree import (grads, to_device, tree_leaves, tree_map,
                              tree_unflatten, with_grad)

logger = logging.getLogger(__name__)
_SFPL = COUNTERS["sfpl"]


class PreparedPerm(NamedTuple):
    """A step's permutation with its routing metadata: ``None`` for the
    dense gather, the ``(forward, backward)`` ``RoutePlan`` pair for
    ``MeshAllToAll``, a per-flush-group tuple of such pairs for
    ``StreamingAllToAll``. Built once per step and shared by the label
    permute, the activation permute and the backward exchange."""
    perm: torch.Tensor
    plans: object


# --------------------------------------------------------------------------
# placements

@dataclasses.dataclass(frozen=True)
class SingleDevice:
    """Everything on one device: every cross-rank reduction is the
    identity."""
    rank = 0
    world = 1
    psum = None

    def local(self, a):
        return a

    def all_sum(self, t):
        return t

    def sum_tree(self, tree):
        return tree

    def collector(self, num_clients, *, alpha=1.0, use_kernel=False):
        return DenseTake(num_clients=num_clients, alpha=alpha,
                         use_kernel=use_kernel)


SINGLE = SingleDevice()


class _AllSum(torch.autograd.Function):
    """Sum over a process group whose gradient is the sum of the
    gradients: every rank's loss depends on every rank's input."""

    @staticmethod
    def forward(ctx, t, group):
        import torch.distributed as dist
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(t, *, group=None):
    """Differentiable all-reduce sum of ``t`` over ``group``."""
    return _AllSum.apply(t, group)


# sub-mesh slice subgroups, by (world, slice size, pods): built once by
# every rank for every slice in the same order (``new_group``'s contract)
_SUBGROUPS = {}


def clear_subgroups():
    """Forget the cached slice subgroups (their process group is gone)."""
    _SUBGROUPS.clear()


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """A process group as the collector's placement: rank ``r`` of
    ``world`` holds the ``r``-th contiguous block of clients (client-
    stacked state and data sliced on their leading axis) and so the
    ``r``-th slab of the pool; server state is replicated. ``group`` is
    the ``torch.distributed`` group (``None``: the default one). Build it
    with ``engine_dist.init_data_group``.

    ``pods`` (a divisor of ``world``) makes it the 2-D pod-major layout
    of the JAX package's ``("pod", "data")`` mesh: the collector still
    runs over every rank in rank order (the flattened shard index), and
    each pod's ``world // pods`` consecutive ranks form a subgroup
    (``slice_group``), so a sub-mesh slice must stay inside one pod."""
    group: object
    rank: int
    world: int
    pods: Optional[int] = None

    def slice_group(self, slice_size):
        """Process group of this rank's slice of ``slice_size`` consecutive
        ranks (``collector_dist.submesh_axis_groups``): the group itself
        when the slice is the whole world; otherwise every slice's
        ``new_group``, made by every rank in the same order at the first
        call for this ``(world, slice_size, pods)`` and cached until
        ``engine_dist.close_data_group``."""
        if slice_size == self.world:
            return self.group
        key = (self.world, slice_size, self.pods)
        if key not in _SUBGROUPS:
            import torch.distributed as dist
            _SUBGROUPS[key] = [dist.new_group(ranks) for ranks in
                               submesh_axis_groups(self.world, slice_size)]
        return _SUBGROUPS[key][self.rank // slice_size]

    def local(self, a):
        """This rank's block of a tensor whose leading axis is global."""
        if a.shape[0] % self.world:
            raise ValueError(f"{a.shape[0]} entries do not split over "
                             f"{self.world} ranks")
        per = a.shape[0] // self.world
        return a[self.rank * per:(self.rank + 1) * per]

    @property
    def psum(self):
        """Differentiable sum over the group, or ``None`` on one rank."""
        if self.world == 1:
            return None
        return functools.partial(all_sum, group=self.group)

    def all_sum(self, t):
        """Sum of ``t`` over the group (not differentiated)."""
        if self.world == 1:
            return t
        import torch.distributed as dist
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.group)
        return out

    def sum_tree(self, tree):
        """Leaf-wise sum of a tree over the group in one all-reduce per
        dtype."""
        if self.world == 1:
            return tree
        leaves = tree_leaves(tree)
        out = list(leaves)
        for dt in {leaf.dtype for leaf in leaves}:
            at = [i for i, leaf in enumerate(leaves) if leaf.dtype == dt]
            flat = self.all_sum(torch.cat([leaves[i].reshape(-1)
                                           for i in at]))
            for i, part in zip(at, flat.split([leaves[i].numel()
                                               for i in at])):
                out[i] = part.reshape(leaves[i].shape)
        return tree_unflatten(tree, out)

    def collector(self, num_clients, *, alpha=1.0, mode="balanced",
                  slack=None, use_kernel=None, check_capacity=False,
                  pipeline="sync", stream_slack=None, submesh=None,
                  wire_dtype=None, wire_dtype_bwd=None):
        """The ``all_to_all`` collector over this group: ``pipeline``
        "sync" (``MeshAllToAll``) or "double_buffered"
        (``StreamingAllToAll`` with ``stream_slack`` and ``submesh``)."""
        if pipeline not in ("sync", "double_buffered"):
            raise ValueError(f"unknown collector pipeline {pipeline!r}: "
                             f"expected 'sync' or 'double_buffered'")
        common = dict(placement=self, num_clients=num_clients, mode=mode,
                      alpha=alpha, slack=slack, use_kernel=use_kernel,
                      check_capacity=check_capacity, wire_dtype=wire_dtype,
                      wire_dtype_bwd=wire_dtype_bwd)
        if pipeline == "double_buffered":
            return StreamingAllToAll(stream_slack=stream_slack,
                                     submesh=submesh, **common)
        if submesh:
            raise ValueError(
                "collector_submesh applies to the double_buffered "
                "pipeline (the sync exchange is already dense for "
                "balanced permutations); drop the flag or use "
                "pipeline='double_buffered'")
        return MeshAllToAll(**common)


# --------------------------------------------------------------------------
# collector strategies

@dataclasses.dataclass(frozen=True)
class DenseTake:
    """Algorithm 1's collector as a dense row gather on one device.
    ``use_kernel`` routes float payloads through the ``collector_permute``
    kernel (whose wrapper runs the plain gather for CPU tensors)."""
    num_clients: int
    alpha: float = 1.0
    use_kernel: bool = False

    @property
    def placement(self):
        return SINGLE

    def make_perm(self, gen, n, device=None):
        return C.make_flush_perm(gen, n, self.num_clients, self.alpha,
                                 device)

    def prepare(self, perm, n):
        return PreparedPerm(perm, None)

    @spanned("collector.permute")
    def permute(self, x, prep):
        perm = prep.perm if isinstance(prep, PreparedPerm) else prep
        _count_permuted(x)
        if self.use_kernel and x.is_floating_point():
            return C.shuffle(x, perm, use_kernel=True)
        return x[perm]            # labels: a plain gather, never the kernel


def _count_permuted(x):
    """Add a float payload's bytes to ``COUNTERS["sfpl"]["permuted_bytes"]``
    (labels are not counted)."""
    if x.is_floating_point():
        _SFPL["permuted_bytes"] += x.numel() * x.element_size()


@dataclasses.dataclass(frozen=True)
class MeshAllToAll:
    """Algorithm 1's collector as one ``all_to_all`` per direction over
    the ``placement``'s ranks, driven by a per-step route plan.

    ``mode``: "balanced" draws (per-flush-group) balanced block
    permutations whose pair loads are deterministic, so the plan is dense
    (exact capacity, no overflow accounting); "uniform" draws the paper's
    uniform shuffle (``DenseTake``'s distribution) into slack-buffered
    buckets sized by ``uniform_auto_slack``, with the capacity check on.
    ``slack`` overrides the sizing (and forces slack buffers).
    ``use_kernel=None`` runs the float gathers through K4a/K4b (K5a/K5b on
    a quantized wire) for CUDA tensors. ``wire_dtype`` narrows the smashed
    rows on the wire, ``wire_dtype_bwd`` the routed-back gradient rows."""
    placement: DataGroup
    num_clients: int
    mode: str = "balanced"
    alpha: float = 1.0
    slack: Optional[float] = None
    use_kernel: Optional[bool] = None
    check_capacity: bool = False
    wire_dtype: Optional[str] = None
    wire_dtype_bwd: Optional[str] = None

    def __post_init__(self):
        if self.mode not in ("balanced", "uniform"):
            raise ValueError(f"unknown collector mode {self.mode!r}: "
                             f"expected 'balanced' or 'uniform'")

    def group_rows(self, n):
        per_client = n // self.num_clients
        return [c * per_client
                for c in C.flush_group_sizes(self.num_clients, self.alpha)]

    def plan_spec(self, n):
        """(cap, may_drop) of the step's route plan. Balanced mode takes
        the exact capacity and skips overflow accounting unless the caller
        asked for the capacity check."""
        shards = self.placement.world
        if self.slack is not None:
            return pair_capacity(n, shards, self.slack), True
        rows = self.group_rows(n)
        if self.mode == "uniform":
            slack = uniform_auto_slack(n, shards,
                                       rows if len(rows) > 1 else None)
            return pair_capacity(n, shards, slack), True
        return exact_pair_cap(n, shards, rows), self.check_capacity

    def make_perm(self, gen, n, device=None):
        if self.mode == "uniform":
            return C.make_flush_perm(gen, n, self.num_clients, self.alpha,
                                     device)
        return make_grouped_balanced_perm(
            gen, n, self.placement.world, self.group_rows(n)).to(device)

    def prepare(self, perm, n):
        """Build the (forward, backward) route plans once per step."""
        cap, may_drop = self.plan_spec(n)
        return PreparedPerm(perm, build_route_plans(
            perm, self.placement.world, cap=cap, may_drop=may_drop))

    def _check(self):
        return self.check_capacity or (self.mode == "uniform"
                                       and self.slack is None)

    def _wire(self, dtype):
        """Effective wire of a ``dtype`` payload (``None``: as computed)."""
        return _resolve_wire(dtype, self.wire_dtype)

    def _use_k(self, x):
        """Whether ``x``'s gathers run the kernels (auto: on CUDA)."""
        return self.use_kernel if self.use_kernel is not None else x.is_cuda

    @spanned("collector.permute")
    def permute(self, x, prep):
        """This rank's ``(b, ...)`` slab of the permuted pool, from its own
        slab ``x``; differentiable in ``x``."""
        if not isinstance(prep, PreparedPerm):
            prep = self.prepare(prep, x.shape[0] * self.placement.world)
        _count_permuted(x)
        return plan_shuffle(
            x, prep.plans, group=self.placement.group,
            rank=self.placement.rank, use_kernel=self._use_k(x),
            check_capacity=self._check(), wire_dtype=self.wire_dtype,
            wire_dtype_bwd=self.wire_dtype_bwd)

    def exchange_bytes(self, prep, row_elems, dtype):
        """Wire bytes of one forward pool exchange (the activation
        ``all_to_all``) for ``row_elems``-element rows in ``dtype``, in the
        effective wire dtype, scale lanes included."""
        return plan_payload_bytes(prep.plans[0], row_elems, dtype.itemsize,
                                  wire_dtype=self._wire(dtype))


class _Ticket(NamedTuple):
    """A flush group's exchange in flight: the group, the pool's row
    count, and the ``collector_dist.Slot``."""
    g: int
    n: int
    slot: object


@dataclasses.dataclass(frozen=True)
class StreamingAllToAll(MeshAllToAll):
    """The paper's threshold-queue collector as a two-slot software
    pipeline: each flush group is exchanged with its OWN ``all_to_all``,
    split into ``issue`` (``all_to_all_single(async_op=True)``) and
    ``complete`` (the work handle's ``wait()``), so group ``k``'s exchange
    is in flight while group ``k+1``'s client forward computes.

    Same permutations and plans' capacities as the JAX package, so the
    shuffled pool is row for row the sync ``MeshAllToAll``'s and the
    losses equal the sync path's: the grouped permutation never crosses
    a flush group, so the per-group exchanges move exactly the rows the
    one big exchange would.

    ``submesh`` selects the sub-mesh exchange: when every flush group
    covers the same number ``S`` of whole rank slabs with ``b % S == 0``
    (``collector_dist.submesh_slice_size``), group ``g``'s rows live on
    ranks ``[g*S, (g+1)*S)`` and its exchange is a DENSE plan (exact
    capacity ``b/S``, no overflow count, no pad row) run over that slice's
    subgroup (``DataGroup.slice_group``); the full client forward then
    runs once. ``None`` turns it on exactly when the layout qualifies
    (with ``pods``, only for slices inside one pod: a straddling slice
    takes the fallback, with a warning); ``True`` raises on layouts that
    do not; ``False`` forces the fallback.

    The whole-group fallback exchanges each group over every rank, in
    fine slabs of ``b_g = n_g / world`` rows: rank ``s`` holds group rows
    ``[s*b_g, (s+1)*b_g)``, a layout no rank holds, so each group's rows
    go there and back by one ``collector_dist.relayout`` each way (the
    JAX package leaves these moves to GSPMD; ``relayout_bytes`` counts
    them apart from ``exchange_bytes``). The fallback's client forward
    runs flush group by flush group, and its slack is probed per group
    size (``uniform_auto_slack`` or ``balanced_stream_slack``) with the
    capacity check on; ``stream_slack`` overrides it.

    The layout must pass ``engine_dist.check_sfpl_layout(...,
    collector_pipeline="double_buffered")``."""
    stream_slack: Optional[float] = None
    submesh: Optional[bool] = None

    pipelined = True

    def group_bounds(self, n):
        """(start, stop) row ranges of the flush groups in the pool."""
        bounds, start = [], 0
        for size in self.group_rows(n):
            bounds.append((start, start + size))
            start += size
        return bounds

    def client_groups(self):
        """(first, last + 1) client ranges of the flush groups."""
        out, c0 = [], 0
        for c in C.flush_group_sizes(self.num_clients, self.alpha):
            out.append((c0, c0 + c))
            c0 += c
        return out

    def submesh_slices(self, n):
        """Ranks per owning slice when sub-mesh routing is on for an
        ``n``-row pool, else ``None`` (resolves the ``submesh`` knob;
        ``True`` raises on a layout that does not qualify, naming why)."""
        if self.submesh is False:
            return None
        world, pods = self.placement.world, self.placement.pods
        reason, slices = None, None
        if self.mode != "balanced":
            reason = ("sub-mesh routing needs the deterministic per-pair "
                      "loads of collector_mode='balanced'; uniform "
                      "permutations fall back to the slack-buffered "
                      "whole-mesh exchange")
        elif self.slack is not None or self.stream_slack is not None:
            reason = ("an explicit slack/stream_slack override forces the "
                      "slack-buffered whole-mesh plan shape")
        else:
            slices = submesh_slice_size(n, world, self.group_rows(n))
            if slices is None:
                reason = ("every flush group must cover the same number "
                          "of whole shard slabs, with the slab divisible "
                          "by that span (collector_dist."
                          "submesh_slice_size)")
            elif pods and slices != world and (world // pods) % slices:
                reason = (f"a {slices}-shard slice straddles the pod "
                          f"boundary (each pod holds {world // pods} "
                          f"shards) — cross-pod flush groups take the "
                          f"probed-slack whole-mesh exchange")
                slices = None
                if not self.submesh:
                    logger.warning("sub-mesh routing disabled: %s", reason)
        if slices is None and self.submesh:
            raise ValueError(
                f"collector_submesh=True but the layout does not qualify "
                f"for the sub-mesh streaming exchange: {reason} "
                f"(num_clients={self.num_clients}, alpha={self.alpha}, "
                f"n={n}, shards={world})")
        return slices

    def _check(self):
        # the fallback's auto slacks are probed (empirical), so the
        # capacity check is on whenever they are in play; dense sub-mesh
        # plans carry no overflow count
        return self.check_capacity or (self.slack is None
                                       and self.stream_slack is None)

    def _sub_slack(self, n_g, span=1):
        """Fallback slack of one ``n_g``-row flush group covering ``span``
        original slabs (the block count of its balanced sub-permutation)."""
        if self.stream_slack is not None:
            return self.stream_slack
        world = self.placement.world
        if self.mode == "uniform":
            return uniform_auto_slack(n_g, world)
        return balanced_stream_slack(n_g, world, span)

    def prepare(self, perm, n):
        """Per-flush-group (forward, backward) route plans, built once per
        step and shared by the label permute, the issue / complete
        exchanges and ``route_back``: dense sub-mesh plans, or slack-
        buffered whole-group plans at each group's ``_sub_slack``. Under
        sub-mesh routing every rank makes the slice subgroups here, before
        the step's first exchange."""
        world = self.placement.world
        slices = self.submesh_slices(n)
        b = n // world
        plans = []
        for g, (r0, r1) in enumerate(self.group_bounds(n)):
            sub = perm[r0:r1] - r0
            if slices is not None:
                plans.append(build_submesh_route_plans(sub, g, world,
                                                       slices))
            else:
                n_g = r1 - r0
                span = n_g // b if n_g % b == 0 else 1
                cap = pair_capacity(n_g, world, self._sub_slack(n_g, span))
                plans.append(build_route_plans(sub, world, cap=cap,
                                               may_drop=True))
        if slices is not None:
            self.placement.slice_group(slices)
        return PreparedPerm(perm, tuple(plans))

    @staticmethod
    def _plans_are_submesh(prep):
        return prep.plans[0][0].slice_size is not None

    def _own(self, prep):
        """Sub-mesh: the flush group whose slice holds this rank."""
        return self.placement.rank // prep.plans[0][0].slice_size

    def home_rows(self, n, g):
        """(lo, hi): this rank's rows of flush group ``g`` in its own slab
        of an ``n``-row pool (local indices; empty when it holds none)."""
        b = n // self.placement.world
        r0, r1 = self.group_bounds(n)[g]
        base = self.placement.rank * b
        return min(max(r0 - base, 0), b), min(max(r1 - base, 0), b)

    def _relayout(self, x, n, g, reverse=False):
        r0, r1 = self.group_bounds(n)[g]
        place = self.placement
        return relayout(x, relayout_counts(r0, r1, n // place.world,
                                           place.world),
                        group=place.group, rank=place.rank,
                        reverse=reverse)

    def issue(self, rows, prep, g):
        """Start flush group ``g``'s exchange; returns the in-flight
        ticket, or ``None`` on a rank outside group ``g``'s sub-mesh
        slice (it takes no part). ``rows`` is this rank's whole slab under
        sub-mesh plans, its home rows of group ``g`` on the fallback
        (moved to the fine slabs here, by a blocking ``relayout``)."""
        place = self.placement
        plan = prep.plans[g][0]
        n = prep.perm.shape[0]
        if plan.slice_size is not None and g != self._own(prep):
            return None
        _count_permuted(rows)
        if plan.slice_size is not None:
            group = place.slice_group(plan.slice_size)
        else:
            rows = self._relayout(rows, n, g)
            group = place.group
        return _Ticket(g, n, plan_exchange_issue(
            rows, plan, group=group, rank=place.rank,
            use_kernel=self._use_k(rows), check_capacity=self._check(),
            wire_dtype=self.wire_dtype))

    def complete(self, ticket):
        """Land an in-flight ticket: this rank's shuffled rows of the
        group (its slab under sub-mesh plans; its home rows of the group,
        moved back from the fine slabs, on the fallback). The slot carries
        the wire context, so a quantized wire lands compute-dtype rows
        (K5b)."""
        if ticket is None:
            return None
        slot = ticket.slot
        out = plan_exchange_complete(slot, rank=self.placement.rank,
                                     use_kernel=self._use_k(slot.recv))
        if slot.plan.slice_size is None:
            out = self._relayout(out, ticket.n, ticket.g, reverse=True)
        return out

    def assemble(self, parts, prep, n):
        """This rank's slab of the shuffled pool from its per-group
        parts."""
        if self._plans_are_submesh(prep):
            return _combine_slices(parts, self._own(prep))
        return _concat_parts(parts)

    @spanned("collector.permute")
    def permute(self, x, prep, skip=None):
        """Blocking shuffle of this rank's slab ``x`` under the per-group
        plans (the label pool, which never interleaves with client
        compute): one exchange per flush group. ``skip`` (per-group bools,
        elastic participation) passes a fully dropped group's rows
        through unexchanged: every row of it is masked downstream."""
        n = x.shape[0] * self.placement.world
        if not isinstance(prep, PreparedPerm):
            prep = self.prepare(prep, n)
        submesh = self._plans_are_submesh(prep)
        parts = []
        for g in range(len(prep.plans)):
            rows = x if submesh else x[slice(*self.home_rows(n, g))]
            if skip and skip[g]:
                parts.append(rows)
                continue
            parts.append(self.complete(self.issue(rows, prep, g)))
        return self.assemble(parts, prep, n)

    def exchange_bytes(self, prep, row_elems, dtype, skip=None):
        """Wire bytes of one forward pool exchange: the sum of the flush
        groups' ``plan_payload_bytes`` in the effective wire dtype,
        leaving out groups that ``skip`` passes through."""
        wire = self._wire(dtype)
        return sum(plan_payload_bytes(plans[0], row_elems, dtype.itemsize,
                                      wire_dtype=wire)
                   for g, plans in enumerate(prep.plans)
                   if not (skip and skip[g]))

    def relayout_bytes(self, prep, row_elems, dtype, skip=None):
        """Bytes the fallback's re-layouts move between ranks in one
        forward pool exchange, in and out, in the compute dtype (0 under
        sub-mesh plans, and for groups whose fine slabs are their home
        slabs)."""
        if self._plans_are_submesh(prep):
            return 0
        n = prep.perm.shape[0]
        world = self.placement.world
        rows = 0
        for g, (r0, r1) in enumerate(self.group_bounds(n)):
            if skip and skip[g]:
                continue
            counts = relayout_counts(r0, r1, n // world, world)
            rows += 2 * sum(counts[h][s] for h in range(world)
                            for s in range(world) if h != s)
        return rows * row_elems * dtype.itemsize

    def route_back(self, g_shuf, prep, n, skip=None):
        """Algorithm 1's de-shuffle, explicit: the per-group exchange
        under the BACKWARD plans hands each rank its clients' activation
        gradients (``g_shuf`` and the result are this rank's slab), move
        for move what autograd does on the sync path. ``skip`` passes a
        fully dropped group's (zero) gradient rows through."""
        if not isinstance(prep, PreparedPerm):
            prep = self.prepare(prep, n)
        place = self.placement
        use_k = self._use_k(g_shuf)
        if self._plans_are_submesh(prep):
            own = self._own(prep)
            if skip and skip[own]:
                return g_shuf
            plan = prep.plans[own][1]
            return plan_exchange(g_shuf, plan,
                                 group=place.slice_group(plan.slice_size),
                                 rank=place.rank, use_kernel=use_k,
                                 wire_dtype=self.wire_dtype_bwd)
        parts = []
        for g in range(len(prep.plans)):
            rows = g_shuf[slice(*self.home_rows(n, g))]
            if skip and skip[g]:
                parts.append(rows)
                continue
            out = plan_exchange(self._relayout(rows, n, g), prep.plans[g][1],
                                group=place.group, rank=place.rank,
                                use_kernel=use_k,
                                wire_dtype=self.wire_dtype_bwd)
            parts.append(self._relayout(out, n, g, reverse=True))
        return _concat_parts(parts)


def _concat_parts(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _combine_slices(parts, own):
    """This rank's slab of a sub-mesh shuffle. Only the exchange of the
    rank's own flush group (``own``, the group its slice owns) involves
    it: the ranks outside a slice take no part in that slice's
    collective, so every other part is ``None`` (or, for a skipped group,
    the unexchanged slab) and the rank keeps its own group's rows. The
    JAX package's masked select over pool-width parts reduces to this."""
    return parts[own]


def streamed_shuffle(collector, prep, n, produce_group, skip=None):
    """Two-slot software pipeline over flush groups.

    ``produce_group(g)`` returns this rank's rows of flush group ``g``
    (its client forward of the group, in ``sfpl_round``), or its whole
    slab under sub-mesh plans. The filled slot's exchange is ISSUED
    before the next group's rows are produced and COMPLETED after, so
    the ``all_to_all`` overlaps the next group's compute; the last
    in-flight slot is DRAINED after the loop. ``skip`` (per-group bools)
    passes fully dropped groups through with no collective. Returns this
    rank's slab of the shuffled pool, row for row
    ``collector.permute`` of the whole pool."""
    if not isinstance(prep, PreparedPerm):
        prep = collector.prepare(prep, n)
    n_groups = len(collector.group_bounds(n))
    parts, slot = [], None
    for g in range(n_groups):
        ticket = passthrough = None
        if slot is not None:
            if skip and skip[g - 1]:
                passthrough = slot
            else:
                ticket = collector.issue(slot, prep, g - 1)
        rows = produce_group(g)
        if passthrough is not None:
            parts.append(passthrough)
        elif slot is not None:
            parts.append(collector.complete(ticket))
        slot = rows
    # drain epilogue: the last filled buffer is still to be exchanged
    last = n_groups - 1
    if skip and skip[last]:
        parts.append(slot)
    else:
        parts.append(collector.complete(collector.issue(slot, prep, last)))
    return collector.assemble(parts, prep, n)


def _gate(mask, new, old):
    """Keep ``new`` for participating clients, ``old`` for absent ones."""
    return tree_map(lambda nl, ol: torch.where(
        mask.reshape((-1,) + (1,) * (nl.dim() - 1)), nl, ol), new, old)


def make_client_update(split, opt_c):
    """Local client backprop + optimizer step given the routed-back dA.

    It re-runs the client forward to differentiate it, fed the BN state
    the step's first forward already advanced, so SFPL moves the client
    BN running statistics twice per step, exactly as the JAX engine does.
    Works on one client or on client-stacked trees alike."""
    def client_upd(cp, cbn, copt, x, da, step):
        cp_g = with_grad(cp)
        with torch.enable_grad():
            a, ncs = split.client_fwd(cp_g, cbn, x, True, None)
            g_cp = grads(a, cp_g, da)
        cp_new, copt_new = opt_c.update(g_cp, copt, cp, step)
        return cp_new, copt_new, ncs
    return client_upd


def _participation(participation, num_clients, device):
    if participation is None:
        return None
    part = torch.as_tensor(participation).to(device=device, dtype=torch.bool)
    if part.dim() not in (1, 2) or part.shape[-1] != num_clients:
        raise ValueError(
            f"participation mask must have shape ({num_clients},) or "
            f"(steps, {num_clients}); got {tuple(part.shape)}")
    return part


# --------------------------------------------------------------------------
# SFPL round (Algorithm 1 + 2)

@spanned("sfpl.round")
def sfpl_round(gen, st, data, split, opt_c, opt_s, *, num_clients,
               batch_size, bn_mode="cmsd", collector, participation=None,
               device=None):
    """One SFPL epoch over the ``n // batch_size`` local batches.

    Each step: every client runs its forward (all of a rank's clients in
    one stacked call); ``collector`` pools and shuffles the smashed data;
    the server takes ONE update on the shuffled pool; autograd routes the
    activation gradients back; every client takes a local step. At epoch
    end ClientFedServer runs FedAvg ("cmsd" excludes BatchNorm, "rmsd"
    aggregates it).

    ``collector.placement`` says where the clients live. On one device
    ``st`` and ``data`` hold all ``num_clients`` clients. On a
    ``DataGroup`` they hold this rank's block of clients (client-stacked
    leaves sliced, server leaves replicated; see
    ``engine_dist.shard_dcml_state``), and every cross-rank reduction of
    the step (server BN moments, the loss's valid count, the server
    gradients, FedAvg) runs over the group.

    ``gen`` is the ``torch.Generator`` the collector draws its per-step
    permutations of the whole pool from; every rank seeds it alike.
    ``participation`` (optional bool mask over all clients,
    ``(num_clients,)`` or ``(steps, num_clients)``) is elastic
    participation: absent clients' rows stay in the pool but are masked
    out of the server update exactly (activations zeroed, labels ignored,
    BN statistics over valid rows only), their local state is gated back
    to the pre-step values, and FedAvg averages over participants only.
    Returns ``(state, losses)`` with ``losses`` of shape (steps,), the
    global loss on every rank.
    """
    dev = resolve_device(device)
    place = collector.placement
    st, data = to_device(st, dev), to_device(data, dev)
    n_local = data["x"].shape[1]
    steps = n_local // batch_size
    n_pool = num_clients * batch_size
    client_upd = make_client_update(split, opt_c)
    part = _participation(participation, num_clients, dev)
    srv_kw = {} if place.psum is None else {"reduce": place.psum}
    streamed = getattr(collector, "pipelined", False)
    # sub-mesh routing depends on the layout only: under it each rank's
    # clients already are its group's rows, so the full forward runs once
    submesh = streamed and collector.submesh_slices(n_pool) is not None
    skip = _static_skip(collector, participation) if streamed else None
    losses = []

    for idx in range(steps):
        with span("sfpl.step"):
            with span("sfpl.perm"):
                xb = data["x"][:, idx * batch_size:(idx + 1) * batch_size]
                yb = data["y"][:, idx * batch_size:(idx + 1) * batch_size]
                y_pool = yb.reshape(-1)
                perm = collector.make_perm(gen, n_pool, dev)
                prep = collector.prepare(perm, n_pool)
                y_shuf = (collector.permute(y_pool, prep, skip=skip)
                          if streamed else collector.permute(y_pool, prep))
                mask_c = valid_shuf = None
                kw = dict(srv_kw)
                if part is not None:
                    mask_all = part[idx] if part.dim() == 2 else part
                    mask_c = place.local(mask_all)
                    # the pool's row mask through the same (replicated)
                    # permutation, cut to this rank's slab
                    kw["valid"] = place.local(
                        mask_all.repeat_interleave(batch_size)[perm])

            sp_g = with_grad(st["sp"])
            if streamed:
                # 1.+2. pipelined: the pool is shuffled group by group
                # outside the loss, so the de-shuffle is the explicit
                # route_back under the backward plans, move for move
                # autograd's on the sync path
                with span("sfpl.client_fwd"), torch.no_grad():
                    A, ncbn, a_shuf = _streamed_forward(
                        collector, prep, n_pool, split, st, xb, submesh,
                        skip)
                a_shuf.requires_grad_()
                with span("sfpl.server_fwd"), torch.enable_grad():
                    loss, (nsbn, _) = split.server_loss(
                        sp_g, st["sbn"], a_shuf, y_shuf, True, None, **kw)
                with span("sfpl.server_bwd"):
                    with torch.enable_grad():
                        g_all = grads(loss, {"sp": sp_g, "a": a_shuf})
                    g_pool = collector.route_back(g_all["a"], prep, n_pool,
                                                  skip=skip)
                    # each rank's loss holds its slab's share of the mean
                    g_sp = place.sum_tree(g_all["sp"])
            else:
                # 1. client forward, all of this rank's clients at once
                with span("sfpl.client_fwd"), torch.no_grad():
                    A, ncbn = split.client_fwd(st["cp"], st["cbn"], xb, True,
                                               None)

                # 2.+3. pool client-major, shuffle, ONE server update. The
                # loss is a function of the PRE-shuffle pool, so its
                # gradient arrives already routed back to the source
                # clients.
                a_pool = A.reshape((-1,) + tuple(A.shape[2:])) \
                    .requires_grad_()
                with torch.enable_grad():
                    a_shuf = collector.permute(a_pool, prep)
                    with span("sfpl.server_fwd"):
                        loss, (nsbn, _) = split.server_loss(
                            sp_g, st["sbn"], a_shuf, y_shuf, True, None,
                            **kw)
                with span("sfpl.server_bwd"):
                    with torch.enable_grad():
                        g_all = grads(loss, {"sp": sp_g, "a": a_pool})
                    g_pool = g_all["a"]
                    # each rank's loss holds its slab's share of the mean
                    g_sp = place.sum_tree(g_all["sp"])
            _SFPL["steps"] += 1
            sp_new, sopt_new = opt_s.update(g_sp, st["sopt"], st["sp"],
                                            st["step"])

            # 4. client backprop and local steps (dA is pooled like A)
            with span("sfpl.client_upd"):
                dA = g_pool.reshape(A.shape)
                cp_new, copt_new, ncbn2 = client_upd(
                    st["cp"], ncbn, st["copt"], xb, dA, st["step"])
                if mask_c is not None:
                    # absent clients take no local step: weight decay,
                    # momentum and the BN running update are gated back
                    # to the old state
                    cp_new = _gate(mask_c, cp_new, st["cp"])
                    copt_new = _gate(mask_c, copt_new, st["copt"])
                    ncbn2 = _gate(mask_c, ncbn2, st["cbn"])

            st = dict(st, cp=cp_new, cbn=ncbn2, sp=sp_new, sbn=nsbn,
                      copt=copt_new, sopt=sopt_new, step=st["step"] + 1)
            losses.append(place.all_sum(loss.detach()))

    # 5. ClientFedServer, over every client of every rank
    with span("sfpl.fedavg"):
        exclude = bn_mode == "cmsd"
        w = None
        if part is not None:
            w = place.local((part if part.dim() == 1
                             else part.any(dim=0)).float())
        st = dict(st, cp=fedavg(st["cp"], weights=w, exclude_bn=exclude,
                                reduce=place.psum),
                  cbn=aggregate_bn_state(st["cbn"], aggregate=not exclude,
                                         weights=w, reduce=place.psum))
    return st, torch.stack(losses)


def _static_skip(collector, participation):
    """Per-flush-group bools of a per-epoch mask: a group whose clients
    all dropped is passed through with no exchange (``None`` when no
    group is dropped, or the mask is per step)."""
    if participation is None:
        return None
    if isinstance(participation, torch.Tensor):
        participation = participation.cpu().numpy()
    mask = np.asarray(participation).astype(bool)
    if mask.ndim != 1:
        return None
    skip = tuple(not mask[c0:c1].any() for c0, c1 in
                 collector.client_groups())
    return skip if any(skip) else None


def _streamed_forward(collector, prep, n_pool, split, st, xb, submesh,
                      skip):
    """Client forward and streamed shuffle of one step: ``(A, ncbn,
    a_shuf)``, this rank's stacked smashed data, new client BN state and
    slab of the shuffled pool. Under sub-mesh plans the forward of all
    the rank's clients runs once; otherwise it runs flush group by flush
    group (this rank's clients of the group), each group produced while
    the previous group's exchange is in flight."""
    if submesh:
        A, ncbn = split.client_fwd(st["cp"], st["cbn"], xb, True, None)
        a_slab = A.reshape((-1,) + tuple(A.shape[2:]))
        return A, ncbn, streamed_shuffle(collector, prep, n_pool,
                                         lambda g: a_slab, skip=skip)
    per = n_pool // collector.num_clients          # rows a client
    A_parts, bn_parts = [], []

    def produce_group(g):
        lo, hi = (r // per for r in collector.home_rows(n_pool, g))
        cut = lambda t: tree_map(lambda a: a[lo:hi], t)
        if lo == hi:
            # no client of this group here: no rows, but the right row
            # shape for the re-layout (one client's forward, dropped)
            one = lambda t: tree_map(lambda a: a[:1], t)
            a1, _ = split.client_fwd(one(st["cp"]), one(st["cbn"]), xb[:1],
                                     True, None)
            A_g, ncbn_g = a1[:0], cut(st["cbn"])
        else:
            A_g, ncbn_g = split.client_fwd(cut(st["cp"]), cut(st["cbn"]),
                                           xb[lo:hi], True, None)
        A_parts.append(A_g)
        bn_parts.append(ncbn_g)
        return A_g.reshape((-1,) + tuple(A_g.shape[2:]))

    a_shuf = streamed_shuffle(collector, prep, n_pool, produce_group,
                              skip=skip)
    return (torch.cat(A_parts),
            tree_map(lambda *xs: torch.cat(xs), *bn_parts), a_shuf)


# --------------------------------------------------------------------------
# SFLv2 round (the baseline under study)

def visit_order(gen, num_clients):
    """SFLv2's random client visitation order for one epoch."""
    return torch.randperm(num_clients, generator=gen).tolist()


def _take(tree, k):
    return tree_map(lambda a: a[k], tree)


def _put(tree, k, value):
    def put(a, v):
        a = a.clone()
        a[k] = v
        return a
    return tree_map(put, tree, value)


def sflv2_round(gen, st, data, split, opt_c, opt_s, *, num_clients,
                batch_size, aggregate_bn=True, placement=SINGLE,
                device=None):
    """One SFLv2 epoch: clients visited SEQUENTIALLY in random order, the
    server training on each client's single-class stream in turn. This
    sequential structure is the catastrophic-forgetting mechanism under
    study and is never parallelized.

    ``placement`` (a ``DataGroup``) splits each visited client's batch
    over its ranks instead, the server stream running data parallel:
    state and data are replicated, every rank draws the same visit order
    from ``gen``, the BN moments (client and server) and the loss's count
    run over the whole batch (``reduce``), and each update sums the
    ranks' gradients, so every rank holds the same state."""
    dev = resolve_device(device)
    st, data = to_device(st, dev), to_device(data, dev)
    steps = data["x"].shape[1] // batch_size
    place = placement
    kw = {} if place.psum is None else {"reduce": place.psum}
    losses = []
    for k in visit_order(gen, num_clients):
        cp, cbn, copt = _take(st["cp"], k), _take(st["cbn"], k), \
            _take(st["copt"], k)
        sp, sbn, sopt, step = st["sp"], st["sbn"], st["sopt"], st["step"]
        for idx in range(steps):
            xb = place.local(
                data["x"][k, idx * batch_size:(idx + 1) * batch_size])
            yb = place.local(
                data["y"][k, idx * batch_size:(idx + 1) * batch_size])
            cp_g, sp_g = with_grad(cp), with_grad(sp)
            with torch.enable_grad():
                A, ncbn = split.client_fwd(cp_g, cbn, xb, True, None, **kw)
                A_in = A.detach().requires_grad_()
                loss, (nsbn, _) = split.server_loss(sp_g, sbn, A_in, yb,
                                                    True, None, **kw)
                g_s = grads(loss, {"sp": sp_g, "a": A_in})
                g_cp = grads(A, cp_g, g_s["a"])
            sp, sopt = opt_s.update(place.sum_tree(g_s["sp"]), sopt, sp,
                                    step)
            cp, copt = opt_c.update(place.sum_tree(g_cp), copt, cp, step)
            cbn, sbn, step = ncbn, nsbn, step + 1
            losses.append(place.all_sum(loss.detach()))
        st = dict(st, cp=_put(st["cp"], k, cp), cbn=_put(st["cbn"], k, cbn),
                  copt=_put(st["copt"], k, copt), sp=sp, sbn=sbn, sopt=sopt,
                  step=step)
    st = dict(st, cp=fedavg(st["cp"], exclude_bn=False),
              cbn=aggregate_bn_state(st["cbn"], aggregate=aggregate_bn))
    return st, torch.stack(losses).reshape(num_clients, steps)
