"""Tensor-tree checkpointing to .npz.

Leaves are flattened to ``path -> array`` with '/'-joined dict keys (the
JAX package's key layout); restore rebuilds into the reference tree's
structure (shape verified, dtype re-cast to the reference leaf and the
tensor placed on its device — bf16 round-trips through exact f32
widening, since numpy has no bf16).

Writes are crash-safe: the archive is written to a sibling temp file
through an open handle (so numpy cannot append its own ``.npz`` suffix),
fsync'd, and atomically ``os.replace``d over the target — a reader either
sees the old complete checkpoint or the new complete checkpoint, never a
torn one.

:func:`save_train_state` / :func:`restore_train_state` extend the plain
tree snapshot to the full training state needed for bit-compatible
resume: params + optimizer state + BN statistics (the ``st`` dict), the
state of the host ``torch.Generator`` that draws the next epoch (the
``key`` leaf, where the JAX package keeps its PRNG key), and the epoch
counter. A sharded run gathers its client blocks onto every rank before
it saves (``engine_dist.gather_clients``, a collective); then only rank 0
writes.

A file the JAX package wrote has the same keys, with conv kernels in its
HWIO layout: read it with ``np.load`` and carry it over through
``repro_torch.convert.from_jax_numpy``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.tree import tree_map_with_path


def _key(path):
    return "/".join(str(k) for k in path)


def _to_numpy(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:   # numpy has no bf16: exact widening,
        t = t.float()               # re-cast on restore
    return t.numpy()


def _flatten(tree):
    flat = {}

    def put(path, leaf):
        flat[_key(path)] = _to_numpy(torch.as_tensor(leaf))
    tree_map_with_path(put, tree)
    return flat


def save_checkpoint(path, tree, *, step=None, write=True):
    """Snapshot ``tree`` (a nest of dicts of tensors) to ``path``
    atomically. ``write=False`` fetches the leaves to the host but skips
    the file I/O (every rank of a group calls the save; one writes)."""
    flat = _flatten(tree)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    if not write:
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        # An open handle pins the destination name: np.savez appends
        # ".npz" to bare paths but writes file objects verbatim.
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def restore_checkpoint(path, ref_tree):
    """Restore into ``ref_tree``'s structure. Returns (tree, step|None).

    Raises ``ValueError`` (not ``assert`` — asserts vanish under
    ``python -O``) on a missing leaf or a shape mismatch against the
    reference tree; each leaf takes the reference leaf's dtype and
    device.
    """
    with np.load(path) as data:
        step = data["__step__"] if "__step__" in data.files else None

        def take(pathk, ref):
            key = _key(pathk)
            if key not in data.files:
                raise ValueError(
                    f"checkpoint {path!r} has no leaf {key!r} — reference "
                    f"tree does not match the saved structure")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(
                    f"checkpoint {path!r} leaf {key!r} has shape "
                    f"{tuple(arr.shape)}, reference expects "
                    f"{tuple(ref.shape)}")
            return torch.from_numpy(np.array(arr)).to(dtype=ref.dtype,
                                                      device=ref.device)
        tree = tree_map_with_path(take, ref_tree)
    return tree, (int(step) if step is not None else None)


# --------------------------------------------------------------------------
# Full training state (params + opt state + BN stats + generator + epoch)


def _is_writer():
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def save_train_state(path, st, *, gen, epoch, write=None):
    """Snapshot the full training state for mid-training resume.

    ``st`` is the DCML state dict (client/server params, optimizer states,
    BN statistics, step counter), whole on this rank; ``gen`` the host
    ``torch.Generator`` that draws the NEXT epoch, stored as its
    ``get_state()`` in the ``key`` leaf; ``epoch`` the number of epochs
    already finished. ``write=None``: rank 0 writes when a process group
    is up, else this process.
    """
    if write is None:
        write = _is_writer()
    save_checkpoint(path, {"st": st, "key": gen.get_state()}, step=epoch,
                    write=write)


def restore_train_state(path, st_ref):
    """Returns ``(st, gen_state, epoch)`` restored against ``st_ref``'s
    structure, shapes, dtypes and devices (a freshly initialised state
    works); hand ``gen_state`` to ``torch.Generator.set_state``."""
    key_ref = torch.Generator().get_state()
    tree, epoch = restore_checkpoint(path, {"st": st_ref, "key": key_ref})
    if epoch is None:
        raise ValueError(
            f"checkpoint {path!r} has no epoch counter (__step__) — was it "
            f"written by save_train_state?")
    return tree["st"], tree["key"], epoch
