"""Plain PyTorch versions of the collector row gathers (K1, K4a, K4b)."""
from __future__ import annotations


def collector_permute(x, perm):
    """``out[i] = x[perm[i]]`` along axis 0."""
    return x[perm]


def bucket_permute(x, idx):
    """Send-side bucket gather: x (R, ...), idx (S, cap) ->
    ``out[s*cap + r] = x[idx[s, r]]``, (S*cap, ...)."""
    return x[idx.reshape(-1)]


def unbucket_permute(x, idx):
    """Receive-side gather: x (R, ...) flat received block, idx (B,) ->
    ``out[i] = x[idx[i]]``, (B, ...)."""
    return x[idx]
