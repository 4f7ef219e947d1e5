"""Nested-dict parameter trees: the port's stand-in for JAX pytrees.

Every tree is a nest of ``dict``s with tensors at the leaves. Leaves are
visited in sorted key order at every level, which is the order
``jax.tree_util`` uses for dicts, so leaf lists line up across the two
packages.
"""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` with ``path`` the tuple of keys to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], path + (k,))
                for k in sorted(tree)}
    return fn(path, tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """Rebuild a tree shaped like ``like`` from ``leaves`` (in
    ``tree_leaves`` order)."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def to_device(tree, device):
    return tree_map(lambda t: t.to(device), tree)


def with_grad(tree):
    """The leaves detached from any graph and marked to require grad: the
    inputs of one ``torch.autograd.grad`` call."""
    return tree_map(lambda t: t.detach().requires_grad_(), tree)


def grads(out, tree, grad_out=None):
    """Gradient tree of ``out`` (a scalar, or a tensor with cotangent
    ``grad_out``) with respect to the leaves of ``tree``."""
    leaves = tree_leaves(tree)
    gs = torch.autograd.grad(out, leaves, grad_outputs=grad_out,
                             allow_unused=True)
    return tree_unflatten(tree, [torch.zeros_like(leaf) if g is None else g
                                 for g, leaf in zip(gs, leaves)])
