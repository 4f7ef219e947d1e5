"""Entry points for the three DCML schemes on one device: SFPL, SFLv2, FL.

  * SFPL: per local-batch step all clients run their forward, the global
    collector pools and shuffles the smashed data, ONE server update runs
    on the shuffled pool, the activation gradients are routed back and
    every client takes a local step. At epoch end ClientFedServer averages
    the client models, excluding BatchNorm ("cmsd").
  * SFLv2: clients visited sequentially in random order; the server model
    trains on each client's single-class stream in turn.
  * FL: every client trains the full model locally; FedAvg over all.

Clients are a leading axis N of the client-side trees. The step bodies
live in :mod:`repro_torch.core.round`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import round as RD
from repro_torch.core.bn_policy import aggregate_bn_state, fedavg
from repro_torch.core.collector import check_participation
from repro_torch.core.round import make_client_update  # noqa: F401
from repro_torch.device import resolve_device
from repro_torch.models.common import IGNORE_LABEL, softmax_cross_entropy
from repro_torch.tree import grads, to_device, tree_map, with_grad


@dataclasses.dataclass(frozen=True)
class SplitModel:
    # (cparams, cstate, x, training, rmsd[, reduce]) -> (smashed,
    # new_cstate); takes one client's trees, or client-stacked trees with
    # stacked x; ``reduce`` takes one client's BN statistics over its
    # batch split across ranks (sharded SFLv2)
    client_fwd: Callable
    # (sparams, sstate, A, y, training, rmsd[, valid][, reduce]) ->
    #     (loss, (new_sstate, logits)); ``reduce`` (a differentiable sum
    #     over ranks) takes the BN statistics and the loss's valid count
    #     over a pool split across ranks
    server_loss: Callable
    # (params, state, x, y, training, rmsd) -> (loss, (new_state, logits))
    full_loss: Callable


def make_resnet_split(cfg, policy=None):
    """SplitModel closures for the paper's ResNet-8/32/56.

    ``policy`` (a ``models.common.ComputePolicy``) selects the mixed-
    precision path: f32 master params (autograd through the in-loss cast
    gives f32 grads), convs and BN+ReLU epilogues in the compute dtype,
    smashed data in that dtype, the loss reduced in f32, through the fused
    ``softmax_xent`` kernels when ``policy.fused()``. ``None`` keeps the
    plain f32 graph."""
    from repro_torch.models import resnet as R

    if policy is not None and policy.fused():
        from repro_torch.kernels.softmax_xent.ops import softmax_xent
        loss_fn = softmax_xent
    else:
        loss_fn = softmax_cross_entropy

    def client_fwd(cp, cs, x, training=True, rmsd=None, reduce=None):
        return R.client_apply(cp, cs, x, training=training, rmsd=rmsd,
                              policy=policy, reduce=reduce)

    def server_loss(sp, ss, a, y, training=True, rmsd=None, valid=None,
                    reduce=None):
        if valid is not None:
            # absent clients' rows ride along but are inert: activations
            # zeroed, labels ignored, rows left out of every BN statistic
            vb = valid.reshape((-1,) + (1,) * (a.dim() - 1))
            a = torch.where(vb, a, torch.zeros((), dtype=a.dtype,
                                               device=a.device))
            y = torch.where(valid, y.long(), torch.full(
                (), IGNORE_LABEL, dtype=torch.long, device=y.device))
        logits, nss = R.server_apply(sp, ss, a, cfg, training=training,
                                     rmsd=rmsd, policy=policy, valid=valid,
                                     reduce=reduce)
        return loss_fn(logits, y, reduce=reduce), (nss, logits)

    def full_loss(p, s, x, y, training=True, rmsd=None):
        logits, ns = R.apply(p, s, x, cfg, training=training, rmsd=rmsd,
                             policy=policy)
        return loss_fn(logits, y), (ns, logits)

    return SplitModel(client_fwd, server_loss, full_loss)


# --------------------------------------------------------------------------
# state containers

def _replicate(tree, n):
    return tree_map(lambda a: a[None].expand((n,) + tuple(a.shape)).clone(),
                    tree)


def init_dcml_state(gen, init_fn, num_clients, opt_client, opt_server):
    """``init_fn(gen) -> ({"client", "server"} params, state)``; the client
    trees are replicated along a leading client axis."""
    params, state = init_fn(gen)
    return {
        "cp": _replicate(params["client"], num_clients),
        "cbn": _replicate(state["client"], num_clients),
        "sp": params["server"],
        "sbn": state["server"],
        "copt": _replicate(opt_client.init(params["client"]), num_clients),
        "sopt": opt_server.init(params["server"]),
        "step": torch.zeros((), dtype=torch.int32),
    }


def init_fl_state(gen, init_fn, num_clients, opt_full):
    params, state = init_fn(gen)
    full_p = {"client": params["client"], "server": params["server"]}
    full_s = {"client": state["client"], "server": state["server"]}
    return {"p": _replicate(full_p, num_clients),
            "bn": _replicate(full_s, num_clients),
            "opt": _replicate(opt_full.init(full_p), num_clients),
            "step": torch.zeros((), dtype=torch.int32)}


# --------------------------------------------------------------------------
# epochs

def sfpl_epoch(gen, st, data, split: SplitModel, opt_c, opt_s, *,
               num_clients, batch_size, bn_mode="cmsd", alpha=1.0,
               participation=None, device=None):
    """data: {"x": (N, n, H, W, 3), "y": (N, n)}. One SFPL epoch with the
    dense single-device collector. ``bn_mode``: "cmsd" keeps BatchNorm
    local, "rmsd" aggregates it. ``participation`` is checked on the host
    first: every flush group must keep a client. See
    :func:`round.sfpl_round`."""
    check_participation(num_clients, participation, alpha=alpha)
    return RD.sfpl_round(
        gen, st, data, split, opt_c, opt_s, num_clients=num_clients,
        batch_size=batch_size, bn_mode=bn_mode,
        collector=RD.SINGLE.collector(num_clients, alpha=alpha),
        participation=participation, device=device)


def sflv2_epoch(gen, st, data, split: SplitModel, opt_c, opt_s, *,
                num_clients, batch_size, aggregate_bn=True, device=None):
    return RD.sflv2_round(
        gen, st, data, split, opt_c, opt_s, num_clients=num_clients,
        batch_size=batch_size, aggregate_bn=aggregate_bn, device=device)


def fl_epoch(gen, st, data, split: SplitModel, opt_full, *, num_clients,
             batch_size, aggregate_bn=True, device=None):
    """FedAvg: ``st`` holds full-model copies per client, {"p": (N, ...),
    "bn": (N, ...), "opt": (N, ...), "step"}. ``gen`` is unused (FL draws
    nothing) and kept for a uniform signature."""
    del gen
    dev = resolve_device(device)
    st, data = to_device(st, dev), to_device(data, dev)
    steps = data["x"].shape[1] // batch_size
    ps, bns, opts, losses = [], [], [], []
    for k in range(num_clients):
        p = tree_map(lambda a: a[k], st["p"])
        bn = tree_map(lambda a: a[k], st["bn"])
        opt = tree_map(lambda a: a[k], st["opt"])
        step = st["step"]
        for idx in range(steps):
            xb = data["x"][k, idx * batch_size:(idx + 1) * batch_size]
            yb = data["y"][k, idx * batch_size:(idx + 1) * batch_size]
            p_g = with_grad(p)
            with torch.enable_grad():
                loss, (bn_new, _) = split.full_loss(p_g, bn, xb, yb, True,
                                                    None)
                g = grads(loss, p_g)
            p, opt = opt_full.update(g, opt, p, step)
            bn, step = bn_new, step + 1
            losses.append(loss.detach())
        ps.append(p)
        bns.append(bn)
        opts.append(opt)
    stack = lambda trees: tree_map(lambda *xs: torch.stack(xs), *trees)
    p = fedavg(stack(ps), exclude_bn=False)
    bn = aggregate_bn_state(stack(bns), aggregate=aggregate_bn)
    return (dict(st, p=p, bn=bn, opt=stack(opts), step=st["step"] + steps),
            torch.stack(losses).reshape(num_clients, steps))
