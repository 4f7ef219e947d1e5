"""The DCML round engine on one device: SFPL (Algorithm 1 + 2) and SFLv2.

This slice ports the single-device placement of the JAX package's
``core/round.py``: the ``DenseTake`` collector (a dense gather, or the
``collector_permute`` kernel) and the step bodies. The mesh collectors
and route plans come in a later slice.

Gradient de-shuffling is never hand-derived: the server loss is taken as
a function of the PRE-shuffle pool, whose rows require grad, and the
collector's permute is differentiable, so autograd routes the activation
gradients back through the inverse permutation (on the kernel path, the
same kernel with the inverse permutation).

Shape contract: the pool is client-major, ``(num_clients * batch_size,
...)``, row ``c * batch_size + j`` being sample ``j`` of client ``c``;
``make_perm`` returns an ``(n,)`` permutation that never crosses
flush-group boundaries.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import collector as C
from repro_torch.core.bn_policy import aggregate_bn_state, fedavg
from repro_torch.device import resolve_device
from repro_torch.tree import grads, to_device, tree_map, with_grad


class PreparedPerm(NamedTuple):
    """A step's permutation with its routing metadata (``None`` for the
    dense single-device gather)."""
    perm: torch.Tensor
    plans: object


@dataclasses.dataclass(frozen=True)
class SingleDevice:
    """Everything on one device."""

    def collector(self, num_clients, *, alpha=1.0, use_kernel=False):
        return DenseTake(num_clients=num_clients, alpha=alpha,
                         use_kernel=use_kernel)


SINGLE = SingleDevice()


@dataclasses.dataclass(frozen=True)
class DenseTake:
    """Algorithm 1's collector as a dense row gather on one device.
    ``use_kernel`` routes float payloads through the ``collector_permute``
    kernel (whose wrapper runs the plain gather for CPU tensors)."""
    num_clients: int
    alpha: float = 1.0
    use_kernel: bool = False

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

    Each step: every client runs its forward (all clients in one stacked
    call); ``collector`` pools and shuffles the smashed data; the server
    takes ONE update on the shuffled pool; autograd routes the activation
    gradients back through the inverse permutation; every client takes a
    local step. At epoch end ClientFedServer runs FedAvg ("cmsd" excludes
    BatchNorm, "rmsd" aggregates it).

    ``gen`` is the ``torch.Generator`` the collector draws its per-step
    permutations from. ``participation`` (optional bool mask,
    ``(num_clients,)`` or ``(steps, num_clients)``) is elastic
    participation: absent clients' rows stay in the pool but are masked
    out of the server update exactly (activations zeroed, labels ignored,
    BN statistics over valid rows only), their local state is gated back
    to the pre-step values, and FedAvg averages over participants only.
    Returns ``(state, losses)`` with ``losses`` of shape (steps,).
    """
    dev = resolve_device(device)
    st, data = to_device(st, dev), to_device(data, dev)
    n_local = data["x"].shape[1]
    steps = n_local // batch_size
    n_pool = num_clients * batch_size
    client_upd = make_client_update(split, opt_c)
    part = _participation(participation, num_clients, dev)
    losses = []

    for idx in range(steps):
        xb = data["x"][:, idx * batch_size:(idx + 1) * batch_size]
        yb = data["y"][:, idx * batch_size:(idx + 1) * batch_size]
        y_pool = yb.reshape(n_pool)
        perm = collector.make_perm(gen, n_pool, dev)
        prep = collector.prepare(perm, n_pool)
        y_shuf = collector.permute(y_pool, prep)
        mask_c = valid_shuf = None
        if part is not None:
            mask_c = part[idx] if part.dim() == 2 else part
            valid_shuf = mask_c.repeat_interleave(batch_size)[perm]

        # 1. client forward, all clients at once
        with torch.no_grad():
            A, ncbn = split.client_fwd(st["cp"], st["cbn"], xb, True, None)

        # 2.+3. pool client-major, shuffle, ONE server update. The loss is
        # a function of the PRE-shuffle pool, so its gradient arrives
        # already routed back to the source clients.
        a_pool = A.reshape((n_pool,) + tuple(A.shape[2:])).requires_grad_()
        sp_g = with_grad(st["sp"])
        with torch.enable_grad():
            a_shuf = collector.permute(a_pool, prep)
            kw = {} if valid_shuf is None else {"valid": valid_shuf}
            loss, (nsbn, _) = split.server_loss(sp_g, st["sbn"], a_shuf,
                                                y_shuf, True, None, **kw)
            g_all = grads(loss, {"sp": sp_g, "a": a_pool})
        sp_new, sopt_new = opt_s.update(g_all["sp"], st["sopt"], st["sp"],
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
        losses.append(loss.detach())

    # 5. ClientFedServer
    exclude = bn_mode == "cmsd"
    w = None
    if part is not None:
        w = (part if part.dim() == 1 else part.any(dim=0)).float()
    st = dict(st, cp=fedavg(st["cp"], weights=w, exclude_bn=exclude),
              cbn=aggregate_bn_state(st["cbn"], aggregate=not exclude,
                                     weights=w))
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
