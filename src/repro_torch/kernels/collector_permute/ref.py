"""Plain PyTorch version of the collector row gather."""
from __future__ import annotations


def collector_permute(x, perm):
    """``out[i] = x[perm[i]]`` along axis 0."""
    return x[perm]
