"""The DCML round engine: SFPL (Algorithm 1 + 2) and SFLv2.

One ``sfpl_round`` serves every placement:

  * a placement says where state and batches live: ``SingleDevice``, or a
    ``DataGroup`` of ``torch.distributed`` ranks, each holding a
    contiguous block of clients (and so a contiguous slab of the pool)
    with the server state replicated;
  * a collector strategy says how Algorithm 1's collect-shuffle-scatter
    runs: ``DenseTake`` (a dense gather on one device, or the
    ``collector_permute`` kernel) or ``MeshAllToAll`` (one
    ``all_to_all`` per direction under a per-step route plan, with the
    bucket kernels K4a/K4b and, on a quantized wire, K5a/K5b).

The JAX round is SPMD, so its reductions over the whole pool come free.
Here a ``DataGroup`` of several ranks makes them explicit, and on one
device or one rank each is the identity (so that path is unchanged):

  * the server BatchNorm moments over the global pool (a differentiable
    all-reduce, so the backward matches too; client BN stays local);
  * the loss normalised by the global valid count, with the server
    gradients summed across ranks before the optimizer step;
  * FedAvg and the BN-state aggregation over all clients.

Gradient de-shuffling is never hand-derived: the server loss is taken as
a function of the PRE-shuffle pool, whose rows require grad, and both
collectors' permutes are differentiable, so autograd routes the
activation gradients back (the inverse permutation, or the exchange
under the route plan's backward half).

Shape contract: the pool is client-major, ``(num_clients * batch_size,
...)``, row ``c * batch_size + j`` being sample ``j`` of client ``c``;
``make_perm`` returns the replicated ``(n,)`` permutation of the whole
pool, which never crosses flush-group boundaries, and each rank permutes
its own slab.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.core import collector as C
from repro_torch.core.bn_policy import aggregate_bn_state, fedavg
from repro_torch.core.collector_dist import (
    _resolve_wire, build_route_plans, exact_pair_cap,
    make_grouped_balanced_perm, pair_capacity, plan_payload_bytes,
    plan_shuffle, uniform_auto_slack)
from repro_torch.device import resolve_device
from repro_torch.tree import (grads, to_device, tree_leaves, tree_map,
                              tree_unflatten, with_grad)

C2 = "slice C2 (the streaming collector, sub-mesh routing and pods)"


class PreparedPerm(NamedTuple):
    """A step's permutation with its routing metadata: ``None`` for the
    dense gather, the ``(forward, backward)`` ``RoutePlan`` pair for
    ``MeshAllToAll``. Built once per step and shared by the label permute,
    the activation permute and the backward exchange."""
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


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """A 1-D process group as the collector's placement: rank ``r`` of
    ``world`` holds the ``r``-th contiguous block of clients (client-
    stacked state and data sliced on their leading axis) and so the
    ``r``-th slab of the pool; server state is replicated. ``group`` is
    the ``torch.distributed`` group (``None``: the default one). Build it
    with ``engine_dist.init_data_group``."""
    group: object
    rank: int
    world: int

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
                  wire_dtype=None, wire_dtype_bwd=None):
        """The sync ``all_to_all`` collector over this group (the
        streaming one comes with slice C2)."""
        return MeshAllToAll(placement=self, num_clients=num_clients,
                            mode=mode, alpha=alpha, slack=slack,
                            use_kernel=use_kernel,
                            check_capacity=check_capacity,
                            wire_dtype=wire_dtype,
                            wire_dtype_bwd=wire_dtype_bwd)


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

    def permute(self, x, prep):
        perm = prep.perm if isinstance(prep, PreparedPerm) else prep
        if self.use_kernel and x.is_floating_point():
            return C.shuffle(x, perm, use_kernel=True)
        return x[perm]            # labels: a plain gather, never the kernel



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

    def permute(self, x, prep):
        """This rank's ``(b, ...)`` slab of the permuted pool, from its own
        slab ``x``; differentiable in ``x``."""
        if not isinstance(prep, PreparedPerm):
            prep = self.prepare(prep, x.shape[0] * self.placement.world)
        use_k = self.use_kernel if self.use_kernel is not None \
            else x.is_cuda
        return plan_shuffle(
            x, prep.plans, group=self.placement.group,
            rank=self.placement.rank, use_kernel=use_k,
            check_capacity=self._check(), wire_dtype=self.wire_dtype,
            wire_dtype_bwd=self.wire_dtype_bwd)

    def exchange_bytes(self, prep, row_elems, dtype):
        """Wire bytes of one forward pool exchange (the activation
        ``all_to_all``) for ``row_elems``-element rows in ``dtype``, in the
        effective wire dtype, scale lanes included."""
        return plan_payload_bytes(prep.plans[0], row_elems, dtype.itemsize,
                                  wire_dtype=self._wire(dtype))


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
    losses = []

    for idx in range(steps):
        xb = data["x"][:, idx * batch_size:(idx + 1) * batch_size]
        yb = data["y"][:, idx * batch_size:(idx + 1) * batch_size]
        y_pool = yb.reshape(-1)
        perm = collector.make_perm(gen, n_pool, dev)
        prep = collector.prepare(perm, n_pool)
        y_shuf = collector.permute(y_pool, prep)
        mask_c = valid_shuf = None
        kw = dict(srv_kw)
        if part is not None:
            mask_all = part[idx] if part.dim() == 2 else part
            mask_c = place.local(mask_all)
            # the pool's row mask through the same (replicated)
            # permutation, cut to this rank's slab
            kw["valid"] = place.local(
                mask_all.repeat_interleave(batch_size)[perm])

        # 1. client forward, all of this rank's clients at once
        with torch.no_grad():
            A, ncbn = split.client_fwd(st["cp"], st["cbn"], xb, True, None)

        # 2.+3. pool client-major, shuffle, ONE server update. The loss is
        # a function of the PRE-shuffle pool, so its gradient arrives
        # already routed back to the source clients.
        a_pool = A.reshape((-1,) + tuple(A.shape[2:])).requires_grad_()
        sp_g = with_grad(st["sp"])
        with torch.enable_grad():
            a_shuf = collector.permute(a_pool, prep)
            loss, (nsbn, _) = split.server_loss(sp_g, st["sbn"], a_shuf,
                                                y_shuf, True, None, **kw)
            g_all = grads(loss, {"sp": sp_g, "a": a_pool})
        # each rank's loss holds its slab's share of the global mean
        g_sp = place.sum_tree(g_all["sp"])
        sp_new, sopt_new = opt_s.update(g_sp, st["sopt"], st["sp"],
                                        st["step"])

        # 4. client backprop and local steps (dA is pooled like A)
        dA = g_all["a"].reshape(A.shape)
        cp_new, copt_new, ncbn2 = client_upd(st["cp"], ncbn, st["copt"], xb,
                                             dA, st["step"])
        if mask_c is not None:
            # absent clients take no local step: weight decay, momentum
            # and the BN running update are gated back to the old state
            cp_new = _gate(mask_c, cp_new, st["cp"])
            copt_new = _gate(mask_c, copt_new, st["copt"])
            ncbn2 = _gate(mask_c, ncbn2, st["cbn"])

        st = dict(st, cp=cp_new, cbn=ncbn2, sp=sp_new, sbn=nsbn,
                  copt=copt_new, sopt=sopt_new, step=st["step"] + 1)
        losses.append(place.all_sum(loss.detach()))

    # 5. ClientFedServer, over every client of every rank
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
                batch_size, aggregate_bn=True, device=None):
    """One SFLv2 epoch: clients visited SEQUENTIALLY in random order, the
    server training on each client's single-class stream in turn. This
    sequential structure is the catastrophic-forgetting mechanism under
    study and is never parallelized."""
    dev = resolve_device(device)
    st, data = to_device(st, dev), to_device(data, dev)
    steps = data["x"].shape[1] // batch_size
    losses = []
    for k in visit_order(gen, num_clients):
        cp, cbn, copt = _take(st["cp"], k), _take(st["cbn"], k), \
            _take(st["copt"], k)
        sp, sbn, sopt, step = st["sp"], st["sbn"], st["sopt"], st["step"]
        for idx in range(steps):
            xb = data["x"][k, idx * batch_size:(idx + 1) * batch_size]
            yb = data["y"][k, idx * batch_size:(idx + 1) * batch_size]
            cp_g, sp_g = with_grad(cp), with_grad(sp)
            with torch.enable_grad():
                A, ncbn = split.client_fwd(cp_g, cbn, xb, True, None)
                A_in = A.detach().requires_grad_()
                loss, (nsbn, _) = split.server_loss(sp_g, sbn, A_in, yb,
                                                    True, None)
                g_s = grads(loss, {"sp": sp_g, "a": A_in})
                g_cp = grads(A, cp_g, g_s["a"])
            sp, sopt = opt_s.update(g_s["sp"], sopt, sp, step)
            cp, copt = opt_c.update(g_cp, copt, cp, step)
            cbn, sbn, step = ncbn, nsbn, step + 1
            losses.append(loss.detach())
        st = dict(st, cp=_put(st["cp"], k, cp), cbn=_put(st["cbn"], k, cbn),
                  copt=_put(st["copt"], k, copt), sp=sp, sbn=sbn, sopt=sopt,
                  step=step)
    st = dict(st, cp=fedavg(st["cp"], exclude_bn=False),
              cbn=aggregate_bn_state(st["cbn"], aggregate=aggregate_bn))
    return st, torch.stack(losses).reshape(num_clients, steps)
