"""Dry run: trace one train, prefill or decode step of an architecture on
a production mesh with no memory behind it, and report what each device
would hold, compute, move and exchange.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
      --shape train_4k [--multi-pod] [--sfpl] [--out results.json] \\
      [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out-dir out

How it works. A ``fake`` process group of 256 (or, with ``--multi-pod``,
512) ranks is started for the call and torn down after it (a group that
is already up is used as it is). The mesh is laid over it; the params
(from a meta-device init), the optimizer state, the batch (from
``configs.registry.input_specs``) and the decode state are DTensors laid
out by ``repro_torch.sharding`` whose local shards are meta tensors: they
have shapes and no storage, and the fake group's collectives move
nothing. (FakeTensorMode fails DTensor's planning of strided shards on
torch 2.13; meta shards carry the same shapes.) One step of
``launch/steps.py`` then runs eagerly under :class:`StepTracer`, a
dispatch mode that sees each op twice: as a DTensor op, which it lets
DTensor lower, and as the local ops and ``_c10d_functional`` collectives
that one device runs, which it counts.

The numbers, all for one device:
  * ``cost.flops``: ``torch.utils.flop_counter``'s formulas on the local
    ops (FlopCounterMode's, with its decompositions), so a product over a
    sharded dim counts its local share. On a 1x1 mesh it equals
    FlopCounterMode on the plain step.
  * ``cost.bytes_accessed``: the input and output bytes of every local op
    that is not a view: the eager program's unfused traffic, not XLA's
    count after fusion.
  * ``memory.argument_bytes``: the local shards of params, optimizer
    state, batch and state; ``temp_bytes``: the peak of the bytes the
    step allocates (live storages made during the step); ``alias_bytes``:
    those of the step's outputs that take the place of donated arguments
    (params and optimizer state in training, a state that decode does not
    write in place), so that ``argument + temp - alias`` is what a device
    holds at its peak when the runtime writes those outputs over the
    donated arguments, as XLA does (the JAX package's figure, which
    ``summarize`` prints). The eager step donates nothing and holds
    ``argument + temp``; ``chip_smoke.py`` phase 28b holds that against
    ``torch.cuda.max_memory_allocated`` for a prefill and a train step.
    ``output_bytes`` the outputs'; ``code_bytes`` 0 (nothing is
    generated).
  * ``collectives``: ``roofline.collectives.collective_bytes`` of the
    recorded collectives.
  * ``lower_s`` is the trace's wall time and ``compile_s`` is 0.0:
    nothing compiles. The trace is host work, so ``devices`` counts the
    fake mesh.

The configs trace as they ship (``attention_impl="xla"``); a kernel path
under meta shards would need each kernel registered as a custom op with
a shape rule and a FLOP formula.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.registry import input_specs
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.launch.mesh import PRODUCTION_AXES, make_production_mesh
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.optim import sgd_momentum
from repro_torch.roofline.collectives import collective_bytes, xla_name
from repro_torch.sharding import rules as R
from repro_torch.tree import tree_map

_SKIP = None   # ops that only read metadata, as FlopCounterMode skips them


def _metadata_ops():
    global _SKIP
    if _SKIP is None:
        a = torch.ops.aten
        _SKIP = {a.sym_is_contiguous.default, a.is_contiguous.default,
                 a.is_contiguous.memory_format,
                 a.is_strides_like_format.default,
                 a.is_non_overlapping_and_dense.default, a.size.default,
                 a.sym_size.default, a.stride.default, a.sym_stride.default,
                 a.storage_offset.default, a.sym_storage_offset.default,
                 a.numel.default, a.sym_numel.default, a.dim.default,
                 torch.ops.prim.layout.default}
    return _SKIP


def _tensors(tree):
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _propagating():
    """Whether a FakeTensorMode is active: DTensor's sharding propagation
    runs ops under one."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class StepTracer(TorchDispatchMode):
    """Counts one device's work in a step: FLOPs, bytes, collectives and
    the peak of live bytes allocated. DTensor ops are handed back to
    DTensor (``NotImplemented``); the local ops it lowers them to, and
    every op of a plain step, are counted."""

    def __init__(self, keep_text=False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.records = []
        self.live = 0
        self.peak = 0
        self.made = {}              # id(storage) -> nbytes, made in the step
        self.lines = [] if keep_text else None

    def _track(self, out):
        for t in _tensors(out):
            if t.device.type not in ("meta", "cpu", "cuda"):
                continue
            st = t.untyped_storage()
            key = id(st)
            if key in self.made:
                continue
            n = st.nbytes()
            self.made[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key):
        self.live -= self.made.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if func in _metadata_ops():
            return NotImplemented
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if _propagating():
            # DTensor running an op on global-shaped fake tensors to learn
            # its output's shape: no device runs it
            return func(*args, **kwargs)
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if func not in self.registry and \
                func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        ns = getattr(packet, "_qualified_op_name", "")
        if ns.startswith("_c10d_functional"):
            op = xla_name(ns.split("::")[-1])
            if op is not None:
                self.records.append(
                    (op, sum(t.nbytes for t in _tensors(out))))
        if not func.is_view:
            self.bytes += sum(t.nbytes for t in _tensors((args, kwargs)))
            self.bytes += sum(t.nbytes for t in _tensors(out))
            if not func._schema.is_mutable:
                # a view or an in-place op's output holds no new storage
                self._track(out)
        if self.lines is not None:
            self.lines.append(f"{func} -> " + ", ".join(
                f"{t.dtype}{list(t.shape)}" for t in _tensors(out)))
        return out


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree):
    """Bytes of the local shards (or plain tensors) of a tree."""
    return sum(_local(t).nbytes for t in _tensors(tree))


def _storages(tree):
    return {id(_local(t).untyped_storage()) for t in _tensors(tree)}


@contextlib.contextmanager
def fake_world(world_size):
    """A ``fake`` process group of ``world_size`` ranks for the duration
    (this process is rank 0); a group that is already up is used as it
    is, and must have that many ranks."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is up; "
                f"the dry run's mesh needs {world_size}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta_like(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


def trace_step(spec, cfg, shape, mesh, *, sfpl=False, optimizer="sgdm",
               fsdp=True, keep_text=False):
    """Trace one step of ``shape.kind`` on ``mesh`` (a DeviceMesh over an
    existing group) with meta shards. Returns (tracer, memory dict,
    seconds)."""
    with torch.device("meta"):
        params = spec.model.init(None, cfg)
    params = R.distribute(params, R.param_shardings(params, mesh,
                                                    fsdp=fsdp))
    specs = input_specs(spec, cfg, shape)
    tracer = StepTracer(keep_text=keep_text)
    t0 = time.time()
    if shape.kind == "train":
        opt = (sgd_momentum(1e-2, momentum=0.9, state_dtype=torch.float32)
               if optimizer == "sgdm" else optimizer)
        opt_state = opt.init(params)
        batch = R.distribute(_meta_like(specs),
                             R.batch_shardings(specs, mesh))
        if sfpl:
            batch["perm"] = torch.empty((shape.global_batch,),
                                        dtype=torch.int64, device="meta")
        args = (params, opt_state, batch)
        step = make_train_step(spec, cfg, opt, sfpl=sfpl)
        with tracer:
            new_p, new_s, _, loss = step(params, opt_state, 0, batch)
        outputs, donated = (new_p, new_s, loss), (new_p, new_s)
    elif shape.kind == "prefill":
        batch = R.distribute(_meta_like(specs),
                             R.batch_shardings(specs, mesh))
        args = (params, batch)
        with tracer:
            logits = make_prefill_step(spec, cfg)(params, batch)
        outputs, donated = logits, ()
    else:
        state = R.distribute(specs["state"],
                             R.state_shardings(specs["state"], mesh))
        toks = {"tokens": _meta_like(specs["tokens"])}
        toks = R.distribute(toks, R.batch_shardings(toks, mesh))["tokens"]
        args = (params, state, toks)
        with tracer:
            logits, new_state = make_decode_step(spec, cfg)(
                params, state, toks, 0)
        outputs, donated = (logits, new_state), new_state
    seconds = time.time() - t0
    kept = _storages(args)
    alias = sum(_local(t).nbytes for t in _tensors(donated)
                if id(_local(t).untyped_storage()) not in kept)
    memory = {"argument_bytes": local_bytes(args),
              "output_bytes": local_bytes(outputs),
              "temp_bytes": tracer.peak,
              "alias_bytes": alias,
              "code_bytes": 0}
    return tracer, memory, seconds


def lower_one(arch_id, shape_name, *, multi_pod=False, sfpl=False,
              optimizer="sgdm", cfg_overrides=None, keep_text=False,
              fsdp=True, device="cuda", mesh_shape=None):
    """Returns a result dict with memory / cost analysis and collective
    bytes, with the JAX package's keys. ``shape_name`` is a name in
    ``SHAPES`` or an ``InputShape``. ``mesh_shape`` (data, model) replaces
    the production mesh by a ``("data", "model")`` mesh of that shape
    (a 1x1 mesh checks the machinery against a real step); ``device`` is
    the mesh's device type. The mesh lies over a ``fake`` group of its
    size (:func:`fake_world`)."""
    spec = get_arch(arch_id)
    shape = shape_name if isinstance(shape_name, InputShape) \
        else SHAPES[shape_name]
    skip = spec.skip_reason(shape)
    if skip:
        return {"arch": arch_id, "shape": shape.name, "skipped": skip}
    if mesh_shape is None:
        mesh_axes = PRODUCTION_AXES[bool(multi_pod)]
        mesh_name = "2x16x16" if multi_pod else "16x16"
    else:
        mesh_axes = tuple(zip(("data", "model"), mesh_shape))
        mesh_name = "x".join(str(n) for n in mesh_shape)
    overrides = dict(cfg_overrides or {})
    if overrides.get("mesh_axes") is None:
        overrides["mesh_axes"] = mesh_axes
    cfg = spec.make_config(**overrides)
    n_dev = math.prod(n for _, n in mesh_axes)
    with fake_world(n_dev):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        else:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh(device, tuple(mesh_shape),
                                    mesh_dim_names=("data", "model"))
        tracer, memory, seconds = trace_step(
            spec, cfg, shape, mesh, sfpl=sfpl, optimizer=optimizer,
            fsdp=fsdp, keep_text=keep_text)
    result = {
        "arch": arch_id,
        "shape": shape.name,
        "mesh": mesh_name,
        "devices": n_dev,
        "sfpl": sfpl,
        "lower_s": round(seconds, 1),
        "compile_s": 0.0,
        "memory": memory,
        "cost": {"flops": tracer.flops, "bytes_accessed": tracer.bytes},
        "collectives": collective_bytes(tracer.records),
    }
    if keep_text:
        result["trace_text"] = "\n".join(tracer.lines)
    return result


def summarize(res):
    if "skipped" in res:
        return (f"{res['arch']:28s} {res['shape']:12s} SKIP: "
                f"{res['skipped'][:50]}")
    m = res["memory"]
    per_dev = (m["argument_bytes"] or 0) + (m["temp_bytes"] or 0) \
        - (m.get("alias_bytes") or 0)
    coll = sum(v["bytes"] for v in res["collectives"].values())
    return (f"{res['arch']:28s} {res['shape']:12s} {res['mesh']:8s} "
            f"args+temp-alias={per_dev / 2**30:7.2f}GiB/dev "
            f"flops={res['cost']['flops'] or 0:.3e} "
            f"coll={coll / 2**30:.2f}GiB "
            f"compile={res['compile_s']:.1f}s (nothing compiles)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sfpl", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out")
    ap.add_argument("--out-dir")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda, or cpu without a "
                         "card); nothing is allocated on it")
    args = ap.parse_args(argv)

    jobs = []
    if args.all:
        for a in list_archs():
            for s in SHAPES:
                jobs.append((a, s, args.multi_pod))
    else:
        jobs.append((args.arch, args.shape, args.multi_pod))

    results = []
    for arch_id, shape_name, mp in jobs:
        try:
            res = lower_one(arch_id, shape_name, multi_pod=mp,
                            sfpl=args.sfpl, device=args.device)
        except Exception as e:   # record failures, keep sweeping
            res = {"arch": arch_id, "shape": shape_name,
                   "mesh": "2x16x16" if mp else "16x16",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"FAIL {arch_id} {shape_name}: {e}", flush=True)
        results.append(res)
        if "error" not in res:
            print(summarize(res), flush=True)
        if args.out_dir:
            os.makedirs(args.out_dir, exist_ok=True)
            fn = f"{arch_id}_{shape_name}_{res.get('mesh', 'NA')}.json"
            with open(os.path.join(args.out_dir, fn), "w") as f:
                json.dump(res, f, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
