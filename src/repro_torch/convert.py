"""Carry parameter and state trees between the JAX package and the port.

Trees are nested dicts of arrays, as ``R.init``, ``init_dcml_state``,
``init_fl_state`` and the transformer's ``init`` produce them. Keys and
nesting are kept. Only the conv kernels change layout: JAX stores them
HWIO, ``(kh, kw, in, out)``; the port stores them OIHW, ``(out, in, kh,
kw)``. A conv kernel is a leaf named ``w`` with 4 dims, or 5 with a leading
client axis; dense ``w`` leaves have 2, or 3 with a leading client axis or
the transformer's stacked ``num_groups`` axis, and carry across as they
are. That holds for the momentum leaves of an optimizer state too, which
mirror the params. ``to_numpy(from_jax_numpy(t))`` gives back ``t``
bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch


def _is_conv(path, a):
    return bool(path) and path[-1] == "w" and a.ndim in (4, 5)


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def from_jax_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays (JAX layout) -> the port's tensors."""
    def conv(path, a):
        a = np.asarray(a)
        if _is_conv(path, a):
            lead = a.ndim - 4            # 1 with a leading client axis
            a = a.transpose(tuple(range(lead)) + tuple(
                lead + i for i in (3, 2, 0, 1)))
        return torch.from_numpy(np.array(a, order="C")).to(device)
    return _walk(tree, conv)


def to_numpy(tree):
    """The port's tensors -> nested dict of numpy arrays in JAX layout."""
    def conv(path, t):
        a = t.detach().cpu().numpy()
        if _is_conv(path, a):
            lead = a.ndim - 4
            a = a.transpose(tuple(range(lead)) + tuple(
                lead + i for i in (2, 3, 1, 0)))
        return np.array(a, order="C")
    return _walk(tree, conv)
