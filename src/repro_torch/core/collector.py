"""SFPL's global collector function (paper Algorithm 1), on one device.

The collector pools smashed data and labels from all clients, shuffles the
pool before the server trains on it, and de-shuffles the returned
activation gradients so each slice goes back to its source client. The
pool is client-major: row ``k * B + j`` is sample ``j`` of client ``k``.

``shuffle`` / ``deshuffle`` gather rows by a permutation on one device
(float rows through the ``collector_permute`` kernel with
``use_kernel``); ``GlobalCollector`` wraps them for the simulation
engine. The JAX package's ``distributed_shuffle`` is a gather that GSPMD
partitions into collectives; its counterpart here is the explicit
exchange of ``core.round.MeshAllToAll`` (``core.collector_dist``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.collector_permute.ops import inverse_permutation


def make_permutation(gen, n, device=None):
    """A uniform permutation of ``range(n)`` drawn from ``gen`` (int64)."""
    return torch.randperm(n, generator=gen).to(device)


def _permute(x, perm, use_kernel):
    if use_kernel and x.is_floating_point():
        from repro_torch.kernels.collector_permute.ops import (
            collector_permute)
        return collector_permute(x, perm)
    return x[perm]


def shuffle(tree, perm, *, use_kernel=False):
    """Apply ``perm`` along axis 0 of every leaf of a dict (or a tensor);
    ``use_kernel`` takes the float leaves through the kernel."""
    if isinstance(tree, dict):
        return {k: shuffle(v, perm, use_kernel=use_kernel)
                for k, v in tree.items()}
    return _permute(tree, perm, use_kernel)


def deshuffle(tree, perm, *, use_kernel=False):
    """Inverse of ``shuffle``: routes gradients back to source clients."""
    return shuffle(tree, inverse_permutation(perm), use_kernel=use_kernel)


def collect(per_client):
    """(N, B, ...) per-client tensors -> the (N*B, ...) pooled stack."""
    if isinstance(per_client, dict):
        return {k: collect(v) for k, v in per_client.items()}
    return per_client.reshape((-1,) + tuple(per_client.shape[2:]))


def uncollect(pooled, num_clients):
    """Inverse of ``collect``: (N*B, ...) -> (N, B, ...)."""
    if isinstance(pooled, dict):
        return {k: uncollect(v, num_clients) for k, v in pooled.items()}
    return pooled.reshape((num_clients, -1) + tuple(pooled.shape[1:]))


def flush_group_sizes(num_clients, alpha):
    """Clients per collector flush under the paper's accumulation threshold:
    the collector flushes every ceil(alpha*N) client batches, so alpha=1 is
    one global flush and alpha=0.5 with N=10 gives two 5-client pools.

    >>> flush_group_sizes(8, 0.25)
    [2, 2, 2, 2]
    """
    fc = max(1, min(num_clients, round(alpha * num_clients)))
    num_flushes = -(-num_clients // fc)
    return [min(fc, num_clients - f * fc) for f in range(num_flushes)]


def make_flush_perm(gen, n, num_clients, alpha, device=None):
    """Pool permutation honouring the accumulation threshold: rows are
    shuffled within contiguous client-major flush groups, never across
    group boundaries; one ``randperm`` per group from ``gen``."""
    groups = flush_group_sizes(num_clients, alpha)
    if len(groups) <= 1:
        return make_permutation(gen, n, device)
    per_client = n // num_clients
    parts, start = [], 0
    for c in groups:
        size = c * per_client
        parts.append(torch.randperm(size, generator=gen) + start)
        start += size
    return torch.cat(parts).to(device)


def check_participation(num_clients, participation, *, alpha=1.0):
    """Validate an elastic-participation mask on the host.

    ``participation`` is a bool mask of shape ``(num_clients,)`` (per
    epoch) or ``(steps, num_clients)`` (per step). Every flush group must
    keep at least one surviving client. Raises ``ValueError`` naming the
    offending flush group (and step); returns the mask as numpy bools.

    >>> check_participation(4, [True, False, True, True], alpha=0.5)
    array([ True, False,  True,  True])
    """
    if participation is None:
        return None
    if isinstance(participation, torch.Tensor):
        participation = participation.cpu().numpy()
    mask = np.asarray(participation)
    if mask.ndim not in (1, 2) or mask.shape[-1] != num_clients:
        raise ValueError(
            f"participation mask must have shape ({num_clients},) or "
            f"(steps, {num_clients}); got {mask.shape}")
    mask = mask.astype(bool)
    rows = mask[None] if mask.ndim == 1 else mask
    start = 0
    for g, c in enumerate(flush_group_sizes(num_clients, alpha)):
        alive = rows[:, start:start + c].any(axis=1)
        if not alive.all():
            at = "" if mask.ndim == 1 else f" at step {int(np.argmin(alive))}"
            raise ValueError(
                f"participation mask drops ALL clients of flush group {g} "
                f"(clients {start}..{start + c}, alpha={alpha}){at} — "
                f"each flush group needs >= 1 surviving client")
        start += c
    return mask


def participation_row_mask(mask, batch_size):
    """Per-client mask -> client-major pooled row mask: row ``k * B + j``
    is valid iff client ``k`` participates."""
    return torch.as_tensor(mask, dtype=torch.bool).repeat_interleave(
        batch_size)


class GlobalCollector:
    """Stateful convenience wrapper for the simulation engine.

    ``alpha`` mirrors the paper's accumulation threshold (the collector
    waits for ``alpha * N`` client batches before shuffling); in the
    synchronous simulation every client contributes each round, so alpha
    sets how many pooled batches form one shuffle unit."""

    def __init__(self, num_clients, *, alpha=1.0, use_kernel=False):
        self.num_clients = num_clients
        self.alpha = alpha
        self.use_kernel = use_kernel

    def make_pool_perm(self, gen, n, device=None):
        """Permutation honouring the accumulation threshold (see
        ``make_flush_perm``)."""
        return make_flush_perm(gen, n, self.num_clients, self.alpha, device)

    def shuffle_pool(self, gen, per_client_acts, per_client_labels):
        pooled = collect({"a": per_client_acts, "y": per_client_labels})
        n = pooled["a"].shape[0]
        perm = self.make_pool_perm(gen, n, pooled["a"].device)
        shuffled = shuffle(pooled, perm, use_kernel=self.use_kernel)
        return shuffled["a"], shuffled["y"], perm

    def deshuffle_grads(self, grads_pool, perm):
        d = deshuffle({"g": grads_pool}, perm, use_kernel=self.use_kernel)
        return uncollect(d, self.num_clients)["g"]
