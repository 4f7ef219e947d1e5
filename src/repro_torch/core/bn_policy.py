"""Batch-normalization aggregation policies (the second half of SFPL).

Aggregating BN parameters and statistics across clients with non-IID data
hurts (paper §V-C, Tables VI-VIII). SFPL's ClientFedServer averages the
client model *excluding BatchNorm* (each client keeps its local BN); at
inference either the aggregated running statistics (RMSD) or the test
batch's own statistics (CMSD) are used.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map, tree_map_with_path


def is_bn_path(path) -> bool:
    """True if the key path belongs to a BatchNorm layer (keys 'bn*')."""
    return any(str(k).startswith("bn") for k in path)


def _mean(x, weights, reduce=None):
    if reduce is not None:
        # the clients are split over ranks: global weighted sum over the
        # global weight
        w = torch.ones(x.shape[0], device=x.device) if weights is None \
            else weights
        w = w.to(x.dtype)
        avg = reduce(torch.tensordot(w, x, dims=1)) / reduce(w.sum())
    elif weights is None:
        avg = x.mean(dim=0)
    else:
        w = (weights / weights.sum()).to(x.dtype)
        avg = torch.tensordot(w, x, dims=1)
    return avg[None].expand_as(x).contiguous()


def fedavg(stacked_params, *, weights=None, exclude_bn=False, reduce=None):
    """FedAvg over the leading client axis of every leaf, broadcast back to
    every client (Algorithm 2's ClientFedServer). ``exclude_bn=True``
    (SFPL) returns BN leaves unchanged. ``weights`` (elastic
    participation) averages over the surviving clients only. ``reduce``
    (a sum over ranks) averages over the clients of every rank, the
    leaves and ``weights`` holding this rank's clients."""
    def agg(path, x):
        if exclude_bn and is_bn_path(path):
            return x
        return _mean(x, weights, reduce)

    return tree_map_with_path(agg, stacked_params)


def aggregate_bn_state(stacked_state, *, aggregate=False, weights=None,
                       reduce=None):
    """BN running statistics: SFLv2 (RMSD) aggregates them like params,
    SFPL keeps them local. Returns (N, ...) leaves either way."""
    if not aggregate:
        return stacked_state
    return tree_map(lambda x: _mean(x, weights, reduce), stacked_state)
