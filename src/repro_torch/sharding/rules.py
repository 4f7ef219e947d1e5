"""Sharding rules: param / batch / state trees -> partition specs, and
specs -> DTensor placements.

Scheme ("2D FSDP + TP", MaxText-style), the JAX package's:
  * batch / client axis      -> ("pod", "data")  (SFPL: data shards = client
                                groups; the collector exchange runs here)
  * tensor-parallel dims     -> "model" (attention heads, MLP hidden,
                                MoE experts, vocab)
  * FSDP dim                 -> "data" (the remaining large param dim;
                                params are replicated across pods)
  * layer-stack leading dims -> replicated

A spec is a per-dim tuple whose entries are ``None``, an axis name, or a
tuple of axis names: the entries of JAX's ``PartitionSpec``. Every
assignment is divisibility-checked against the mesh: a dim that the axis
does not divide falls back to replicated.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims,
or a ``mesh_axes`` tuple of ``(name, size)`` pairs (a config's
``mesh_axes``): the rules need only the names and sizes.
:func:`placements` turns a spec into one placement a mesh dim, and
:func:`distribute` lays a tree out on a ``DeviceMesh``.
"""
from __future__ import annotations

import math
import os
import re
from typing import NamedTuple

from repro_torch.tree import tree_map, tree_map_with_path

DP_AXES = ("pod", "data")    # batch axis ("pod" absent on single-pod mesh)
TP_AXIS = "model"
FSDP_AXIS = "data"


def _names(path):
    """A tree path joined as the JAX package joins its key path."""
    return "/".join(str(k) for k in path)


# (regex on the joined path, spec template applied to the TRAILING dims).
# Templates use tokens: "tp" -> model axis, "fsdp" -> data axis, None.
# Read once at import, as the JAX package reads it; ``nn/moe.py`` lays the
# experts' products out by the same flag.
MOE_EP_DATA = os.environ.get("REPRO_MOE_EP") == "data"
if MOE_EP_DATA:
    _MOE_RULES = [
        (r"moe/(wi|wg)$",                    ("fsdp", None, "tp")),
        (r"moe/wo$",                         ("fsdp", "tp", None)),
    ]
else:
    _MOE_RULES = [
        (r"moe/(wi|wg)$",                    ("tp", "fsdp", None)),
        (r"moe/wo$",                         ("tp", None, "fsdp")),
    ]

_RULES = _MOE_RULES + [
    (r"router/w$",                           (None, None)),
    (r"(wq|wk|wv)/w$",                       ("fsdp", "tp")),
    (r"(embed|pos_embed)/table$",            ("tp", "fsdp")),
    (r"unembed/w$",                          ("fsdp", "tp")),
    (r"(wo|down|ff_down)/w$",                ("tp", "fsdp")),
    (r"(wi|wg|up|up_main|up_gate|ff_up)/w$", ("fsdp", "tp")),
    (r"w_[rizfo]/w$",                        ("fsdp", "tp")),
    (r"(wq|wk|wv)/b$",                       ("tp",)),
    (r"gates/w$",                            ("fsdp", None)),
    (r"lambda$",                             ("tp",)),
]


class NamedSharding(NamedTuple):
    """A mesh and a spec: the counterpart of JAX's ``NamedSharding``."""
    mesh: object
    spec: tuple

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


def mesh_axes_of(mesh):
    """``((name, size), ...)`` of a ``DeviceMesh`` or a ``mesh_axes``."""
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return tuple((str(a), int(n)) for a, n in mesh)


def _axis_sizes(mesh):
    return dict(mesh_axes_of(mesh))


def placements(spec, mesh):
    """DTensor placements of ``spec`` on ``mesh``: one a mesh dim,
    ``Shard(d)`` where tensor dim ``d`` names that mesh dim, else
    ``Replicate()`` (also on a mesh dim of one device, where the two are
    the same layout). A dim over ``("pod", "data")`` is ``Shard(d)`` on
    both, in mesh order: pod-major, as JAX's tuple is."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a in owner:
                raise ValueError(f"mesh axis {a!r} shards two dims of "
                                 f"{spec}")
            owner[a] = d
    axes = mesh_axes_of(mesh)
    unknown = set(owner) - {a for a, _ in axes}
    if unknown:
        raise ValueError(f"spec {spec} names {sorted(unknown)}, not axes "
                         f"of the mesh {[a for a, _ in axes]}")
    # a mesh dim of one device holds everything: replicated
    return tuple(Shard(owner[a]) if a in owner and n > 1 else Replicate()
                 for a, n in axes)


def local_shape(shape, spec, mesh):
    """The shard shape one device holds (every sharded dim divides)."""
    sizes = _axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        out[d] //= math.prod(sizes[a] for a in axes)
    return tuple(out)


def _resolve(template, shape, sizes, has_pod, fsdp=True):
    del has_pod
    spec = []
    for tok, dim in zip(template, shape):
        if tok is None:
            spec.append(None)
        elif tok == "tp":
            spec.append(TP_AXIS if dim % sizes[TP_AXIS] == 0 else None)
        elif tok == "fsdp":
            spec.append(FSDP_AXIS if fsdp and dim % sizes[FSDP_AXIS] == 0
                        else None)
        else:
            spec.append(None)
    return spec


def spec_for_param(path, leaf_shape, mesh, *, fsdp=True):
    """The spec of one param leaf; ``path`` is its tuple of keys."""
    name = _names(path)
    sizes = _axis_sizes(mesh)
    has_pod = "pod" in sizes
    # xlstm block-diagonal qkv: trailing (num_blocks, bs, bs) with tiny bs
    if re.search(r"(wq|wk|wv)/w$", name) and len(leaf_shape) >= 3 \
            and leaf_shape[-1] == leaf_shape[-2] and leaf_shape[-1] <= 16:
        lead = len(leaf_shape) - 3
        return tuple([None] * lead + _resolve(
            ("tp", None, None), leaf_shape[lead:], sizes, has_pod, fsdp))
    for pattern, template in _RULES:
        if not re.search(pattern, name):
            continue
        nd = len(template)
        if len(leaf_shape) < nd:
            continue
        lead = len(leaf_shape) - nd
        return tuple([None] * lead + _resolve(
            template, leaf_shape[lead:], sizes, has_pod, fsdp))
    return ()   # replicate (norms, biases, convs, small tensors)


def param_shardings(params, mesh, *, fsdp=True):
    """A tree of tensors (meta or real) -> a tree of ``NamedSharding``.

    ``fsdp=False`` replicates the FSDP dims over "data" (pure TP)."""
    return tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, spec_for_param(path, tuple(leaf.shape), mesh, fsdp=fsdp)),
        params)


# --------------------------------------------------------------------------
# batch / decode-state shardings

def _dp(mesh):
    sizes = _axis_sizes(mesh)
    return tuple(a for a in DP_AXES if a in sizes)


def batch_shardings(batch, mesh):
    """Shard the leading batch dim over ("pod", "data"); if the batch does
    not divide (long_500k batch 1), shard the sequence dim over "data"."""
    sizes = _axis_sizes(mesh)
    dp = _dp(mesh)
    dp_size = math.prod(sizes[a] for a in dp)

    def one(path, leaf):
        del path
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) >= 1 and shape[0] % dp_size == 0 and shape[0] > 1:
            spec[0] = dp
        elif len(shape) >= 2 and shape[1] % sizes["data"] == 0:
            spec[1] = "data"      # sequence sharding fallback
        return NamedSharding(mesh, tuple(spec))

    return tree_map_with_path(one, batch)


def state_shardings(state, mesh):
    """Decode caches / recurrent states.

    KV cache (B, slots, K, D): batch over dp when divisible; otherwise the
    slots axis over "data" (a sequence-sharded cache, "ring decode").
    kv-head dim over "model" when divisible, else the slots over "model".
    Leading stacked layer dims are skipped (the dims before the
    recognised suffix)."""
    sizes = _axis_sizes(mesh)
    dp = _dp(mesh)
    dp_size = math.prod(sizes[a] for a in dp)

    def one(path, leaf):
        name = _names(path)
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if re.search(r"(^|/)(k|v)$", name) and len(shape) >= 4:
            b, sl, kh = len(shape) - 4, len(shape) - 3, len(shape) - 2
            if shape[b] % dp_size == 0 and shape[b] > 1:
                spec[b] = dp
            elif shape[sl] % sizes["data"] == 0:
                spec[sl] = "data"
            if shape[kh] % sizes[TP_AXIS] == 0:
                spec[kh] = TP_AXIS
            elif spec[sl] is None and shape[sl] % sizes[TP_AXIS] == 0:
                # kv heads not TP-divisible: shard cache slots over model
                spec[sl] = TP_AXIS
        elif re.search(r"(^|/)pos$", name) and len(shape) >= 2:
            b, sl = len(shape) - 2, len(shape) - 1
            if shape[b] % dp_size == 0 and shape[b] > 1:
                spec[b] = dp
            if shape[sl] % sizes[TP_AXIS] == 0:
                spec[sl] = TP_AXIS
            elif spec[b] is None and shape[sl] % sizes["data"] == 0:
                spec[sl] = "data"
        else:
            # recurrent states ([groups], B, ...): first dp-divisible dim
            # is the batch; everything else replicated (states are small)
            for i, d in enumerate(shape):
                if d > 1 and d % dp_size == 0:
                    spec[i] = dp
                    break
        return NamedSharding(mesh, tuple(spec))

    return tree_map_with_path(one, state)


def distribute(tree, shardings):
    """Lay each leaf of ``tree`` out as a DTensor by its ``NamedSharding``
    (whose mesh is a ``DeviceMesh``). Every rank passes the full tensor;
    each keeps its shard."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda t, s: distribute_tensor(t, s.mesh, s.placements),
                    tree, shardings)

