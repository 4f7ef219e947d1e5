"""Carry parameter and state trees between the JAX package and the port.

Trees are nested dicts of arrays, as ``R.init``, ``init_dcml_state``,
``init_fl_state`` and the transformer's ``init`` produce them. Keys and
nesting are kept. Only the conv kernels change layout: JAX stores them
HWIO, ``(kh, kw, in, out)``; the port stores them OIHW, ``(out, in, kh,
kw)``. A conv kernel is the ``w`` leaf of a conv layer (``conv1``,
``conv2``, a residual ``proj``, or one conv layer's own params), with 4
dims or 5 with a leading client axis. Every other leaf carries across as
it is: dense ``w`` leaves, and the xLSTM's block-diagonal ``wq`` / ``wk``
/ ``wv`` weights, whose ``(num_groups, blocks, 4, 4)`` leaves have 4 dims
but are no conv, nor are the MoE experts' ``wi`` / ``wg`` / ``wo``. That
holds for the momentum leaves of an optimizer state too, which mirror the
params. A bf16 leaf (llama4-maverick's parameters; numpy's bf16 is
``ml_dtypes``') carries its bits across. ``to_numpy(from_jax_numpy(t))``
gives back ``t`` bit for bit.
"""
from __future__ import annotations

import re

import numpy as np
import torch

# the parents of conv kernels in the ResNet tree (models/resnet.py)
_CONV_PARENT = re.compile(r"conv\d+|proj")


def _is_conv(path, a):
    """A 4- or 5-dim ``w`` of a conv layer: under a conv parent, or the
    ``w`` of a lone conv layer's params (path ``("w",)``)."""
    return (bool(path) and path[-1] == "w" and a.ndim in (4, 5)
            and (len(path) == 1
                 or _CONV_PARENT.fullmatch(path[-2]) is not None))


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
        a = np.array(a, order="C")
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)
    return _walk(tree, conv)


def to_numpy(tree):
    """The port's tensors -> nested dict of numpy arrays in JAX layout."""
    def conv(path, t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:     # numpy has no bf16 of its own
            import ml_dtypes
            a = t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        else:
            a = t.numpy()
        if _is_conv(path, a):
            lead = a.ndim - 4
            a = a.transpose(tuple(range(lead)) + tuple(
                lead + i for i in (2, 3, 1, 0)))
        return np.array(a, order="C")
    return _walk(tree, conv)
