"""DTensor mechanics shared by the layers and the models: the specs of
the sharding constraints (per-dim roles guarded by divisibility), the
redistribution to a spec (the counterpart of JAX's
``with_sharding_constraint``), the regions that run on local shards
(``local_map`` with specs), and the FSDP and sequence gathers before a
product. Every function is the identity, or the plain op, on a plain
tensor."""
from __future__ import annotations

import math
import sys

import torch

from repro_torch.sharding.rules import mesh_axes_of, placements

_DTENSOR = []


def is_dtensor(x):
    """Whether ``x`` is a DTensor. No DTensor exists before its module is
    loaded, so the plain path never imports it (a few seconds on a
    first call); the class is looked up once it is there."""
    if not _DTENSOR:
        mod = sys.modules.get("torch.distributed.tensor")
        if mod is None:
            return False
        _DTENSOR.append(mod.DTensor)
    return isinstance(x, _DTENSOR[0])


def dp_tp(mesh_axes):
    """(dp axes, dp size, tp size) of a ``mesh_axes`` tuple."""
    sizes = dict(mesh_axes)
    dp = tuple(a for a, _ in mesh_axes if a != "model")
    return dp, math.prod(sizes[a] for a in dp), sizes.get("model", 1)


def apply_spec(x, mesh_axes, spec):
    """``x`` redistributed to the placements of ``spec`` (per-dim ``None``,
    an axis name or a tuple of names) on its own mesh: the counterpart of
    JAX's ``with_sharding_constraint``. The identity on a plain tensor.
    Raises if the DTensor's mesh is not ``mesh_axes``."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    if mesh_axes_of(mesh) != tuple(tuple(a) for a in mesh_axes):
        raise ValueError(f"a DTensor on the mesh {mesh_axes_of(mesh)} under "
                         f"a config for {tuple(mesh_axes)}")
    target = placements(tuple(spec) + (None,) * (x.dim() - len(spec)),
                        mesh_axes)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


class _GradLike(torch.autograd.Function):
    """The identity, whose backward lays the gradient out as the forward
    value was laid out (a pending sum's as replicated). Two gradients of
    one tensor then add in one layout, and a product's gradient arrives
    with its rows sharded as plainly as its input's were, which keeps
    DTensor on its cheap redistribution plans."""

    @staticmethod
    def forward(ctx, y):
        from torch.distributed.tensor import Replicate
        # a pending sum's gradient is the same on every rank
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def grad_like(y):
    """:class:`_GradLike` on a DTensor that takes a gradient; else ``y``."""
    if not is_dtensor(y) or not y.requires_grad:
        return y
    return _GradLike.apply(y)


def dp_spec(mesh_axes, dim):
    """The dp axes where they divide ``dim`` (a batch or group dim), else
    None."""
    return dims_spec((dim,), mesh_axes, ("dp",))[0]


def shard_start(mesh, mesh_dims, size):
    """The first index of this device's shard of a dim of ``size`` split
    over ``mesh_dims`` (in mesh order), and the shard's length."""
    n = size // math.prod(mesh.size(m) for m in mesh_dims)
    start = 0
    for m in mesh_dims:
        start = start * mesh.size(m) + mesh.get_local_rank(m)
    return start * n, n


def local_region(fn, mesh_axes, in_specs, out_specs, partial_grads=()):
    """``fn`` run on each device's local shards when its arguments are
    DTensors: the counterpart of a region the JAX package leaves to
    GSPMD, for ops that have no DTensor sharding rule (sorts, scans,
    scatters) and for the kernel wrappers, which take local tensors only.

    Each tensor argument is first laid out by its spec in ``in_specs``
    (a plain tensor counts as replicated, as under
    ``implicit_replication``; ``None`` passes an argument as it is); each
    output is a DTensor with its spec in ``out_specs``. The gradient of
    an argument listed in ``partial_grads`` (by position: a replicated
    weight read by sharded rows, keys read by sharded queries) is a
    pending sum over the mesh axes that shard another argument but not
    this one. With no DTensor argument ``fn`` runs as it is."""
    def run(*args):
        if not any(is_dtensor(a) for a in args):
            return fn(*args)
        from torch.distributed.tensor import DTensor, Replicate
        from torch.distributed.tensor.experimental import local_map
        mesh = next(a.device_mesh for a in args if is_dtensor(a))
        args = tuple(
            DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
            if torch.is_tensor(a) and not isinstance(a, DTensor)
            and s is not None else a for a, s in zip(args, in_specs))
        args = tuple(apply_spec(a, mesh_axes, s)
                     if isinstance(a, DTensor) and s is not None else a
                     for a, s in zip(args, in_specs))
        in_pl = tuple(placements(s, mesh_axes)
                      if isinstance(a, DTensor) and s is not None else None
                      for a, s in zip(args, in_specs))
        # local_map reads a tuple as one placement sequence an output
        if isinstance(out_specs, list):
            out_pl = tuple(placements(s, mesh_axes) for s in out_specs)
        else:
            out_pl = list(placements(out_specs, mesh_axes))
        grad_pl = None
        if partial_grads:
            from torch.distributed.tensor import Partial
            sharded = [any(pl is not None and pl[m].is_shard()
                           for pl in in_pl) for m in range(mesh.ndim)]
            grad_pl = tuple(
                tuple(Partial() if sharded[m] and not p.is_shard() else p
                      for m, p in enumerate(pl))
                if i in partial_grads and pl is not None else pl
                for i, pl in enumerate(in_pl))
        return local_map(fn, out_pl, in_placements=in_pl,
                         in_grad_placements=grad_pl)(*args)
    return run


def pointwise(fn, x):
    """``fn(x)`` for an elementwise ``fn`` that has no DTensor rule (its
    backward has none either): on a DTensor, ``fn`` runs on the local
    shard in ``x``'s own layout, a pending sum (``Partial``) reduced
    first."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return local_map(fn, list(pl), in_placements=(pl,))(x)


def fsdp_gather(w):
    """A DTensor weight with its FSDP shards gathered: every dim sharded
    over a data-parallel axis ("pod", "data") made whole, the
    tensor-parallel ("model") shards kept. FSDP's all-gather before a
    weight is used (its backward is the gradient's reduce-scatter); on a
    plain tensor, the identity."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if p.is_shard() and names[m] != "model" else p
               for m, p in enumerate(w.placements))
    if pl == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


def split_last(x, n, d):
    """``x`` (..., n * d) -> (..., n, d). On a DTensor whose last dim is
    sharded over more devices than divide ``n`` the last dim is gathered
    first: DTensor cannot split a dim unevenly, where GSPMD reshards on
    its own."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        last = x.dim() - 1
        ways = math.prod(x.device_mesh.size(m) for m, p in
                         enumerate(x.placements)
                         if p.is_shard() and p.dim == last)
        if n % ways:
            x = x.redistribute(x.device_mesh, [
                Replicate() if p.is_shard() and p.dim == last else p
                for p in x.placements])
    return x.reshape(*x.shape[:-1], n, d)


def dims_spec(shape, mesh_axes, roles):
    """The spec of a tensor of ``shape`` whose dims take ``roles`` ("dp" |
    "tp" | None a dim), each kept where its axes divide the dim:
    ``models.common.constrain_dims`` lays a DTensor out by it."""
    dp, dp_size, tp = dp_tp(mesh_axes)
    spec = []
    for role, dim in zip(roles, shape):
        if role == "dp" and dim % dp_size == 0 and dim >= dp_size:
            spec.append(dp)
        elif role == "tp" and dim % tp == 0 and dim >= tp:
            spec.append("model")
        else:
            spec.append(None)
    return tuple(spec)


def gather_rows(x):
    """A DTensor activation made ready for products with tensor-parallel
    weights: a pending sum (``Partial``) reduced and the inner (sequence)
    dims made whole, the all-gather that a sequence-parallel activation
    takes before a block's projections (Megatron's SP -> TP step). Only
    the leading (batch) dim and the features stay sharded, so flattening
    the rows keeps a plain row sharding, and DTensor never moves the
    weight instead. A block that feeds one activation to several
    projections gathers it once, before them; on rows already gathered,
    and on a plain tensor, the identity."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    inner = range(1, x.dim() - 1)
    pl = tuple(Replicate() if p.is_partial()
               or (p.is_shard() and p.dim in inner) else p
               for p in x.placements)
    if pl == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)
