"""Training launcher of the port: LM mode (default) and paper mode (the
DCML rounds).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \
        --steps 50 [--sfpl] [--ckpt out.npz] [--full] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --paper \
        --clients 8 --epochs 4 [--scheme sflv2] [--alpha 0.5] \
        [--compute-dtype bfloat16] [--ckpt state.npz --ckpt-every 1] \
        [--resume state.npz] [--drop-rate 0.2 --straggler-rate 0.1 \
        --straggler-timeout 0.5] [--device cpu]
    PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.train \
        --paper --sharded [--collector uniform] [--wire-dtype int8] \
        [--wire-dtype-bwd int8] [--pipeline double_buffered] \
        [--submesh | --no-submesh] [--pods 2] [--scheme sflv2] --device cpu

LM mode trains an architecture's smoke config (``--full``: the full one)
on the synthetic Markov token stream with AdamW (or SGD) under a cosine
schedule; ``--sfpl`` inserts the cut-layer collector shuffle into the
transformer's step; ``--ckpt`` saves the params at the end (read back by
``launch.eval``). Its parameters and data are drawn from a generator
seeded by ``--seed``.

Paper mode runs SFPL (Algorithm 1 + 2, default) or the SFLv2 baseline on
the synthetic CIFAR set with a split ResNet, one client per class (only
positive labels). It runs on CUDA unless ``--device cpu`` is given, and raises when
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

Fault tolerance (SFPL): ``--drop-rate`` / ``--straggler-rate`` drive a
deterministic ``core.faults.FaultPlan`` whose per-epoch participation
mask is threaded into the round; ``--ckpt`` with ``--ckpt-every`` saves
the full training state and ``--resume`` continues from it bit for bit.
"""
from __future__ import annotations

import argparse
import os
import time

import torch


def train_lm(arch_id, *, steps=50, batch=8, seq=64, smoke=True, sfpl=False,
             lr=3e-3, optimizer="adamw", ckpt=None, log_every=10, seed=0,
             device=None):
    """Train ``arch_id``'s smoke config (``smoke=False``: the full one) for
    ``steps`` steps on fresh batches of the synthetic token stream;
    returns the per-step losses. Parameters, batches, whisper's
    ``frame_embeds`` (``LM_FRAMES`` frames), a VLM's ``vision_embeds`` and
    (``sfpl``) the collector permutations come from one generator seeded
    by ``seed`` on the device; ``ckpt`` saves the final params with the
    step count. ``sfpl`` shuffles at the cut layer for the transformer
    family; the other families run their plain loss, as in the JAX
    package."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.core.split_lm import make_collector_perm
    from repro_torch.data.tokens import (LM_FRAMES, frame_embeds,
                                         synthetic_token_stream,
                                         vision_embeds)
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_train_step, trainable
    from repro_torch.optim import adamw, cosine_lr, sgd_momentum

    dev = resolve_device(device)
    spec = get_arch(arch_id)
    cfg = spec.make_smoke_config() if smoke else spec.make_config()
    model = spec.model
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(gen, cfg)
    opt = (adamw(cosine_lr(lr, steps)) if optimizer == "adamw"
           else sgd_momentum(cosine_lr(lr, steps), momentum=0.9))
    opt_state = opt.init(trainable(params))
    step_fn = make_train_step(spec, cfg, opt, sfpl=sfpl)

    step = 0
    t0 = time.time()
    losses = []
    for i in range(steps):
        toks, labels = synthetic_token_stream(gen, batch=batch, seq_len=seq,
                                              vocab=cfg.vocab_size)
        batch_in = {"tokens": toks, "labels": labels}
        if spec.family == "whisper":
            batch_in["frame_embeds"] = frame_embeds(gen, batch, LM_FRAMES,
                                                    cfg)
        if getattr(cfg, "vision_tokens", 0):
            batch_in["vision_embeds"] = vision_embeds(gen, batch, cfg)
        if sfpl:
            batch_in["perm"] = make_collector_perm(gen, batch)
        params, opt_state, step, loss = step_fn(params, opt_state, step,
                                                batch_in)
        losses.append(float(loss))
        if i % log_every == 0 or i == steps - 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    if ckpt:
        save_checkpoint(ckpt, params, step=step)
        print(f"saved checkpoint to {ckpt}")
    return losses


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
                ckpt=None, ckpt_every=0, resume=None,
                straggler_timeout=None, drop_rate=0.0, straggler_rate=0.0,
                straggler_delay=1.0, fault_seed=0):
    """DCML rounds on synthetic CIFAR, one client per class. ``scheme``
    picks SFPL or SFLv2; ``alpha`` is the collector's flush threshold;
    ``use_kernel=None`` runs the collector's gathers through their kernels
    when CUDA is present. ``sharded`` runs the scheme over the process
    group's ranks: SFPL with the ``collector`` mode, ``pipeline``,
    ``submesh``, ``pods`` and wire dtypes, SFLv2 with each client's batch
    split over the ranks (see the module docstring). Returns the
    per-epoch mean losses and prints the non-IID accuracy at the end
    (rank 0 prints).

    Fault tolerance (SFPL only): ``drop_rate`` / ``straggler_rate`` drive
    a deterministic :class:`~repro_torch.core.faults.FaultPlan` (seeded
    by ``fault_seed``) whose per-epoch participation mask is threaded
    into the round — absent clients' activations are masked out of
    pooling/BN/loss and their local state is frozen for the epoch.
    ``straggler_timeout=None`` WAITS for stragglers (the host sleeps); a
    finite timeout DROPS-AND-MASKS them. A draw that would empty a flush
    group has its lowest-index client revived (logged). ``ckpt`` +
    ``ckpt_every`` snapshot the full training state (params, optimizer,
    BN stats, the generator's state, epoch) every N epochs and at the
    end; ``resume`` rebuilds data and init from ``seed`` as a fresh run
    does, restores such a snapshot and continues bit-compatibly. On a
    process group every rank gathers the state (a collective) and rank 0
    writes."""
    faults = bool(drop_rate or straggler_rate)
    if faults and scheme != "sfpl":
        raise ValueError("elastic participation (drop/straggler rates) "
                         "requires --scheme sfpl")
    sfpl_sharded = sharded and scheme == "sfpl"
    if not sfpl_sharded and (wire_dtype or wire_dtype_bwd):
        raise ValueError("--wire-dtype applies to the sharded SFPL "
                         "collector: add --sharded (scheme sfpl)")
    if not sfpl_sharded and (pipeline != "sync" or submesh is not None
                             or pods is not None):
        raise ValueError("--pipeline, --submesh and --pods apply to the "
                         "sharded SFPL collector: add --sharded (scheme "
                         "sfpl)")
    from repro_torch import checkpoint as CK
    from repro_torch.core import engine as E
    from repro_torch.core import engine_dist as ED
    from repro_torch.core import round as RD
    from repro_torch.core.evaluate import evaluate_split_noniid
    from repro_torch.core.faults import FaultPlan, ensure_group_survivor
    from repro_torch.data.synthetic import (make_synthetic_cifar,
                                            partition_positive_labels)
    from repro_torch.device import resolve_device
    from repro_torch.models import resnet as R
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.tree import to_device

    plan = FaultPlan(num_clients, seed=fault_seed, drop_rate=drop_rate,
                     straggler_rate=straggler_rate,
                     straggler_delay=straggler_delay) if faults else None
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
        start_ep = 0
        if resume:
            st, gen_state, start_ep = CK.restore_train_state(resume, st)
            gen.set_state(gen_state)
            say(f"resumed from {resume} at epoch {start_ep}")
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

        def save(epoch):
            full = ED.gather_clients(st, group) if sfpl_sharded else st
            CK.save_train_state(ckpt, full, gen=gen, epoch=epoch)

        t0 = time.time()
        mean_losses = []
        for ep in range(start_ep, epochs):
            mask = None
            if plan is not None:
                mask, wait = plan.participation(
                    ep, straggler_timeout=straggler_timeout)
                mask, revived = ensure_group_survivor(mask, num_clients,
                                                      alpha=alpha)
                if revived:
                    say(f"epoch {ep:3d} revived clients {revived} (their "
                        f"flush group would have no survivor)", flush=True)
                say(f"epoch {ep:3d} participation {int(mask.sum())}/"
                    f"{num_clients} (straggler wait {wait:.2f}s)",
                    flush=True)
                if wait:
                    time.sleep(wait)
                mask = torch.from_numpy(mask)
            if sfpl_sharded:
                st, losses = ED.sfpl_epoch_sharded(
                    gen, st, data, split, opt, opt, group=group,
                    num_clients=num_clients, batch_size=batch_size,
                    alpha=alpha, use_kernel=use_kernel,
                    collector_mode=collector, collector_pipeline=pipeline,
                    collector_submesh=submesh, wire_dtype=wire_dtype,
                    wire_dtype_bwd=wire_dtype_bwd, participation=mask,
                    device=dev)
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
                                           collector=coll, participation=mask,
                                           device=dev)
            else:
                raise ValueError(f"unknown scheme {scheme!r}")
            mean_losses.append(float(losses.float().mean()))
            if ep % log_every == 0 or ep == epochs - 1:
                say(f"epoch {ep:3d} loss {mean_losses[-1]:.4f} "
                    f"({time.time() - t0:.1f}s)", flush=True)
            if ckpt and ckpt_every and (ep + 1) % ckpt_every == 0:
                save(ep + 1)
                say(f"epoch {ep:3d} checkpoint -> {ckpt}", flush=True)
        if ckpt:
            save(epochs)
            say(f"saved final training state to {ckpt}")
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
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--sfpl", action="store_true")
    ap.add_argument("--optimizer", default="adamw",
                    help="LM mode only; --paper is SGD-momentum (paper)")
    ap.add_argument("--ckpt")
    ap.add_argument("--paper", action="store_true",
                    help="SFPL round engine on synthetic CIFAR")
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
    ap.add_argument("--lr", type=float, default=None,
                    help="default 3e-3 (LM mode) / 0.05 (--paper)")
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
    ap.add_argument("--ckpt-every", dest="ckpt_every", type=int, default=0,
                    help="paper mode: save the full training state "
                         "(params, optimizer, BN stats, generator state, "
                         "epoch) to --ckpt every N epochs (0: final only)")
    ap.add_argument("--resume",
                    help="paper mode: restore a --ckpt training-state "
                         "snapshot and continue from its epoch")
    ap.add_argument("--straggler-timeout", dest="straggler_timeout",
                    type=float, default=None,
                    help="straggler policy: None waits for stragglers, a "
                         "finite timeout drops-and-masks clients slower "
                         "than it")
    ap.add_argument("--drop-rate", dest="drop_rate", type=float,
                    default=0.0,
                    help="per-(epoch, client) dropout probability "
                         "(deterministic FaultPlan; absent clients are "
                         "masked out of the round)")
    ap.add_argument("--straggler-rate", dest="straggler_rate", type=float,
                    default=0.0,
                    help="per-(epoch, client) straggler probability")
    ap.add_argument("--straggler-delay", dest="straggler_delay", type=float,
                    default=1.0,
                    help="seconds a straggler lags (see "
                         "--straggler-timeout)")
    ap.add_argument("--fault-seed", dest="fault_seed", type=int, default=0,
                    help="FaultPlan seed — the whole fault schedule is a "
                         "pure function of (seed, epoch)")
    args = ap.parse_args(argv)
    if args.paper:
        losses = train_paper(
            num_clients=args.clients, epochs=args.epochs,
            batch_size=args.batch, use_kernel=args.use_kernel,
            depth=args.depth, width=args.width, hw=args.hw,
            lr=args.lr if args.lr is not None else 0.05, scheme=args.scheme,
            alpha=args.alpha, compute_dtype=args.compute_dtype,
            seed=args.seed, device=args.device, sharded=args.sharded,
            collector=args.collector, pipeline=args.pipeline,
            submesh=args.submesh, pods=args.pods,
            wire_dtype=args.wire_dtype, wire_dtype_bwd=args.wire_dtype_bwd,
            ckpt=args.ckpt, ckpt_every=args.ckpt_every, resume=args.resume,
            straggler_timeout=args.straggler_timeout,
            drop_rate=args.drop_rate, straggler_rate=args.straggler_rate,
            straggler_delay=args.straggler_delay,
            fault_seed=args.fault_seed)
    else:
        losses = train_lm(args.arch, steps=args.steps, batch=args.batch,
                          seq=args.seq, smoke=args.smoke, sfpl=args.sfpl,
                          lr=args.lr if args.lr is not None else 3e-3,
                          optimizer=args.optimizer, ckpt=args.ckpt,
                          seed=args.seed, device=args.device)
    if losses and int(os.environ.get("RANK", "0")) == 0:
        print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
