"""Training launcher of the port, paper mode: the DCML rounds.

    PYTHONPATH=src python -m repro_torch.launch.train --paper \
        --clients 8 --epochs 4 [--scheme sflv2] [--alpha 0.5] \
        [--compute-dtype bfloat16] [--device cpu]
    PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.train \
        --paper --sharded [--collector uniform] [--wire-dtype int8] \
        [--wire-dtype-bwd int8] [--pipeline double_buffered] \
        [--submesh | --no-submesh] [--pods 2] [--scheme sflv2] --device cpu

SFPL (Algorithm 1 + 2, default) or the SFLv2 baseline on the synthetic
CIFAR set with a split ResNet, one client per class (only positive
labels). It runs on CUDA unless ``--device cpu`` is given, and raises when
CUDA is absent and no device was asked for. ``--compute-dtype bfloat16``
runs the mixed-precision path: bf16 convs and smashed data through the
fused ``bn_act`` / ``softmax_xent`` kernels, f32 master params, BN
statistics and loss. The collector's shuffle runs through the
``collector_permute`` kernel on the card (``--no-kernel`` keeps the plain
gather).

``--sharded`` runs the epoch over the ranks of a process group
(``torchrun``'s, or world size 1 without it). SFPL: each rank holds a
block of clients, the collector is one ``all_to_all`` per direction in
``--collector {balanced,uniform}`` mode through the bucket kernels, or
one per flush group with ``--pipeline double_buffered`` (each issued
while the next group's client forward runs; ``--submesh`` /
``--no-submesh`` force the exchange over each group's own slice of ranks
or over all of them); ``--pods N`` lays the ranks out as N pods; and
``--wire-dtype`` / ``--wire-dtype-bwd`` narrow the smashed rows and the
routed-back gradient rows on the wire (int8/fp8 through the fused
quantize kernels). SFLv2 (``--scheme sflv2``): the visitation stays
sequential and each client's batch is split over the ranks. gloo on the
CPU, NCCL on the card (one rank per card).

Not in this slice: the fault knobs and checkpoints (``--ckpt``,
``--resume``, ``--drop-rate``, ``--straggler-*``), and LM mode. They raise
``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

LATER = {
    "ckpt": "slice D (fault tolerance and checkpoints)",
    "resume": "slice D (fault tolerance and checkpoints)",
    "drop_rate": "slice D (fault tolerance and checkpoints)",
    "straggler_rate": "slice D (fault tolerance and checkpoints)",
    "straggler_timeout": "slice D (fault tolerance and checkpoints)",
}


def make_compute_policy(compute_dtype, use_kernel=None):
    """``ComputePolicy`` for ``--compute-dtype``, or ``None`` at float32
    (the plain f32 graph). ``use_kernel=None``: fused kernels on when CUDA
    is present."""
    if compute_dtype in (None, "float32"):
        return None
    from repro_torch.models.common import ComputePolicy
    return ComputePolicy(compute_dtype=compute_dtype,
                         use_fused_kernels=use_kernel)


def train_paper(*, num_clients=8, epochs=4, batch_size=8, use_kernel=None,
                depth=8, width=8, hw=8, lr=0.05, scheme="sfpl", alpha=1.0,
                compute_dtype="float32", sharded=False, collector="balanced",
                pipeline="sync", submesh=None, pods=None, wire_dtype=None,
                wire_dtype_bwd=None, log_every=1, seed=0, device=None,
                **later):
    """DCML rounds on synthetic CIFAR, one client per class. ``scheme``
    picks SFPL or SFLv2; ``alpha`` is the collector's flush threshold;
    ``use_kernel=None`` runs the collector's gathers through their kernels
    when CUDA is present. ``sharded`` runs the scheme over the process
    group's ranks: SFPL with the ``collector`` mode, ``pipeline``,
    ``submesh``, ``pods`` and wire dtypes, SFLv2 with each client's batch
    split over the ranks (see the module docstring). Returns the
    per-epoch mean losses and prints the non-IID accuracy at the end
    (rank 0 prints). Knobs of later slices (``LATER``) raise
    ``NotImplementedError``."""
    for knob, value in later.items():
        if knob not in LATER:
            raise TypeError(f"train_paper() got an unexpected keyword "
                            f"argument {knob!r}")
        if value:
            raise NotImplementedError(
                f"{knob} is not ported yet: it comes with {LATER[knob]}")
    sfpl_sharded = sharded and scheme == "sfpl"
    if not sfpl_sharded and (wire_dtype or wire_dtype_bwd):
        raise ValueError("--wire-dtype applies to the sharded SFPL "
                         "collector: add --sharded (scheme sfpl)")
    if not sfpl_sharded and (pipeline != "sync" or submesh is not None
                             or pods is not None):
        raise ValueError("--pipeline, --submesh and --pods apply to the "
                         "sharded SFPL collector: add --sharded (scheme "
                         "sfpl)")
    from repro_torch.core import engine as E
    from repro_torch.core import engine_dist as ED
    from repro_torch.core import round as RD
    from repro_torch.core.evaluate import evaluate_split_noniid
    from repro_torch.data.synthetic import (make_synthetic_cifar,
                                            partition_positive_labels)
    from repro_torch.device import resolve_device
    from repro_torch.models import resnet as R
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.tree import to_device

    dev = resolve_device(device)
    group, own_group = RD.SINGLE, False
    if sharded:
        import torch.distributed as dist
        own_group = not dist.is_initialized()
        group = ED.init_data_group(dev, pods=pods)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    say = print if group.rank == 0 else (lambda *a, **k: None)
    try:
        if use_kernel is None:
            use_kernel = dev.type == "cuda"
        cfg = R.ResNetConfig(depth=depth, num_classes=num_clients,
                             width=width)
        gen = torch.Generator().manual_seed(seed)
        tx, ty, ex, ey = make_synthetic_cifar(
            gen, num_classes=num_clients, train_per_class=4 * batch_size,
            test_per_class=2 * batch_size, hw=hw, device=dev)
        data = partition_positive_labels(tx, ty, num_clients)
        split = E.make_resnet_split(cfg, policy=make_compute_policy(
            compute_dtype, use_kernel))
        opt = sgd_momentum(lr, momentum=0.9, weight_decay=5e-4)
        st = to_device(E.init_dcml_state(gen, lambda g: R.init(g, cfg),
                                         num_clients, opt, opt), dev)
        if sharded:
            shards = ED.fit_shards(num_clients, batch_size, scheme=scheme,
                                   alpha=alpha, collector_mode=collector,
                                   collector_pipeline=pipeline,
                                   collector_submesh=submesh, pods=pods,
                                   max_shards=group.world,
                                   wire_dtype=wire_dtype,
                                   wire_dtype_bwd=wire_dtype_bwd)
            if shards != group.world:
                raise ValueError(
                    f"{scheme} with {num_clients} clients x batch "
                    f"{batch_size} at alpha {alpha} in {collector} mode "
                    f"({pipeline}, submesh={submesh}, pods={pods}) splits "
                    f"over at most {shards} of the {group.world} ranks: "
                    f"run with --nproc_per_node {shards}, or change "
                    f"--clients / --batch / --alpha / --collector")
        if sfpl_sharded:
            say(f"sharded SFPL: {group.world} rank(s), collector="
                f"{collector}, alpha={alpha}, pipeline={pipeline}, "
                f"submesh={submesh}, pods={pods}, wire_dtype={wire_dtype}, "
                f"wire_dtype_bwd={wire_dtype_bwd}", flush=True)
            st = ED.shard_dcml_state(st, group)
            data = ED.shard_client_data(data, group)
        elif sharded:
            say(f"sharded SFLv2: {group.world} rank(s), each client's "
                f"batch of {batch_size} split over them, sequential "
                f"visitation kept", flush=True)
        coll = RD.SINGLE.collector(num_clients, alpha=alpha,
                                   use_kernel=use_kernel)

        t0 = time.time()
        mean_losses = []
        for ep in range(epochs):
            if sfpl_sharded:
                st, losses = ED.sfpl_epoch_sharded(
                    gen, st, data, split, opt, opt, group=group,
                    num_clients=num_clients, batch_size=batch_size,
                    alpha=alpha, use_kernel=use_kernel,
                    collector_mode=collector, collector_pipeline=pipeline,
                    collector_submesh=submesh, wire_dtype=wire_dtype,
                    wire_dtype_bwd=wire_dtype_bwd, device=dev)
            elif sharded and scheme == "sflv2":
                st, losses = ED.sflv2_epoch_sharded(
                    gen, st, data, split, opt, opt, group=group,
                    num_clients=num_clients, batch_size=batch_size,
                    device=dev)
            elif scheme == "sflv2":
                st, losses = E.sflv2_epoch(gen, st, data, split, opt, opt,
                                           num_clients=num_clients,
                                           batch_size=batch_size,
                                           device=dev)
            elif scheme == "sfpl":
                st, losses = RD.sfpl_round(gen, st, data, split, opt, opt,
                                           num_clients=num_clients,
                                           batch_size=batch_size,
                                           collector=coll, device=dev)
            else:
                raise ValueError(f"unknown scheme {scheme!r}")
            mean_losses.append(float(losses.float().mean()))
            if ep % log_every == 0 or ep == epochs - 1:
                say(f"epoch {ep:3d} loss {mean_losses[-1]:.4f} "
                    f"({time.time() - t0:.1f}s)", flush=True)
        if sfpl_sharded:
            st = ED.gather_clients(st, group)
        rep = evaluate_split_noniid(st, split, ex, ey, num_clients,
                                    rmsd=False, batch=2 * batch_size)
        say(f"non-IID accuracy {rep['accuracy']:.1f}% "
            f"(chance {100.0 / num_clients:.1f}%)")
        return mean_losses
    finally:
        if own_group:
            ED.close_data_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paper", action="store_true",
                    help="SFPL round engine on synthetic CIFAR (the only "
                         "mode ported so far)")
    ap.add_argument("--scheme", default="sfpl", choices=("sfpl", "sflv2"))
    ap.add_argument("--alpha", type=float, default=1.0,
                    help="SFPL collector accumulation threshold")
    ap.add_argument("--compute-dtype", dest="compute_dtype",
                    default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--use-kernel", dest="use_kernel", action="store_true",
                    default=None, help="force the collector kernel on "
                    "(default: on when CUDA is present)")
    ap.add_argument("--no-kernel", dest="use_kernel", action="store_false")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--width", type=int, default=8)
    ap.add_argument("--hw", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without CUDA)")
    ap.add_argument("--sharded", action="store_true",
                    help="SFPL over the process group's ranks (torchrun)")
    ap.add_argument("--collector", default="balanced",
                    choices=("balanced", "uniform"),
                    help="sharded collector mode")
    ap.add_argument("--wire-dtype", dest="wire_dtype", default=None,
                    help="wire dtype of the smashed rows (sharded): "
                         "float32, bfloat16, int8 or float8_e4m3")
    ap.add_argument("--wire-dtype-bwd", dest="wire_dtype_bwd", default=None,
                    help="wire dtype of the routed-back gradient rows")
    ap.add_argument("--pipeline", default="sync",
                    choices=("sync", "double_buffered"),
                    help="sharded SFPL collector pipeline: sync (one "
                         "blocking exchange) or double_buffered (one "
                         "exchange a flush group, overlapping the next "
                         "group's client forward)")
    ap.add_argument("--submesh", dest="submesh", action="store_true",
                    default=None,
                    help="force sub-mesh streaming on (default: on when "
                         "the balanced grouped layout qualifies)")
    ap.add_argument("--no-submesh", dest="submesh", action="store_false",
                    help="force the whole-mesh streaming fallback")
    ap.add_argument("--pods", type=int, default=None,
                    help="lay the sharded SFPL ranks out as this many pods "
                         "(the 2-D ('pod', 'data') topology)")
    for flag in ("--ckpt", "--resume", "--drop-rate", "--straggler-rate",
                 "--straggler-timeout"):
        ap.add_argument(flag, default=None)
    args = ap.parse_args(argv)
    if not args.paper:
        raise NotImplementedError("LM mode is not ported yet: it comes with "
                                  "the LM-training slice (ROADMAP section "
                                  "1, 'LM training'); pass --paper")
    later = {k: getattr(args, k) for k in LATER}
    losses = train_paper(num_clients=args.clients, epochs=args.epochs,
                         batch_size=args.batch, use_kernel=args.use_kernel,
                         depth=args.depth, width=args.width, hw=args.hw,
                         lr=args.lr, scheme=args.scheme, alpha=args.alpha,
                         compute_dtype=args.compute_dtype, seed=args.seed,
                         device=args.device, sharded=args.sharded,
                         collector=args.collector, pipeline=args.pipeline,
                         submesh=args.submesh, pods=args.pods,
                         wire_dtype=args.wire_dtype,
                         wire_dtype_bwd=args.wire_dtype_bwd, **later)
    if int(os.environ.get("RANK", "0")) == 0:
        print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
