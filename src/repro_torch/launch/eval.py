"""Evaluation launcher of the port: LM mode (default) and paper mode (SFPL
against SFLv2).

    PYTHONPATH=src python -m repro_torch.launch.eval --arch qwen3-8b \
        [--batches 8] [--seq 64] [--ckpt out.npz] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.eval --paper \
        [--clients 8] [--epochs 4] [--alpha 1.0] [--compute-dtype bfloat16] \
        [--device cpu]
    PYTHONPATH=src torchrun --nproc_per_node 2 -m repro_torch.launch.eval \
        --paper --sharded [--pipeline double_buffered] \
        [--submesh | --no-submesh] [--pods 2] [--wire-dtype int8] \
        --device cpu

The paper's comparison AT MATCHED FLEET SIZE: both schemes trained
through the same round engine on the same data, fleet and placement
(``--sharded``: the ranks of ``torchrun``'s process group, or world size
1 without it), and evaluated on the same held-out set under both test
protocols (IID and non-IID batches), each scheme with the BN treatment
it trained with (SFPL: CMSD, batch statistics; SFLv2: RMSD, aggregated
running statistics). It runs on CUDA unless ``--device cpu`` is given.

LM mode: perplexity and token accuracy of an architecture's smoke
config over the synthetic token stream, its parameters drawn from a
generator seeded by 0 (``launch.train``'s default seed) and, with
``--ckpt``, restored from a ``launch.train`` checkpoint.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import torch


def evaluate_lm(spec, cfg, params, *, batches=8, batch=8, seq=64, seed=0):
    """Returns {loss, ppl, token_accuracy} over ``batches`` batches of the
    synthetic stream, drawn from a generator seeded by ``seed`` on the
    params' device; whisper's ``frame_embeds`` (B, LM_FRAMES, d) and a
    VLM's ``vision_embeds`` (B, vision_tokens, d) come from the same
    generator, after each batch's tokens."""
    from repro_torch.data.tokens import (LM_FRAMES, frame_embeds,
                                         synthetic_token_stream,
                                         vision_embeds)
    from repro_torch.models.common import softmax_cross_entropy
    from repro_torch.tree import tree_leaves
    model = spec.model
    dev = tree_leaves(params)[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    tot_loss, tot_acc = 0.0, 0.0
    with torch.no_grad():
        for _ in range(batches):
            toks, labels = synthetic_token_stream(
                gen, batch=batch, seq_len=seq, vocab=cfg.vocab_size)
            b = {"tokens": toks}
            if spec.family == "whisper":
                b["frame_embeds"] = frame_embeds(gen, batch, LM_FRAMES, cfg)
            if getattr(cfg, "vision_tokens", 0):
                b["vision_embeds"] = vision_embeds(gen, batch, cfg)
            logits, _ = model.forward(params, b, cfg, training=False)
            tot_loss += float(softmax_cross_entropy(logits, labels))
            tot_acc += float((logits.argmax(-1) == labels.long())
                             .float().mean())
    loss = tot_loss / batches
    return {"loss": loss, "ppl": math.exp(min(loss, 30.0)),
            "token_accuracy": tot_acc / batches}


def evaluate_paper(*, num_clients=8, epochs=4, batch_size=8, sharded=False,
                   alpha=1.0, pipeline="sync", submesh=None, pods=None,
                   use_kernel=None, depth=8, width=8, hw=8, lr=0.05,
                   compute_dtype="float32", wire_dtype=None,
                   wire_dtype_bwd=None, seed=0, device=None):
    """Train SFPL and SFLv2 on the same data, fleet size and placement and
    return each scheme's accuracy under BOTH test protocols: ``{"sfpl":
    {"iid": report, "noniid": report, "seconds": s}, "sflv2": {...},
    "num_clients": N, "sharded": bool}``, the reports being
    ``metrics.classification_report`` dicts and ``seconds`` the scheme's
    training wall time. ``compute_dtype="bfloat16"`` runs both schemes on
    the mixed-precision path; ``wire_dtype`` / ``wire_dtype_bwd`` narrow
    the sharded SFPL exchange (SFLv2 has none). ``sharded`` runs both
    over the process group's ranks: SFPL with the clients split and the
    collector's ``pipeline``, ``submesh`` and ``pods``; SFLv2 with each
    client's batch split. The data and both schemes' initial state are
    drawn from ``seed``, each scheme's epochs from ``seed + 1``."""
    from repro_torch.core import engine as E
    from repro_torch.core.evaluate import (evaluate_split_iid,
                                           evaluate_split_noniid)
    from repro_torch.data.synthetic import (make_synthetic_cifar,
                                            partition_positive_labels)
    from repro_torch.device import resolve_device
    from repro_torch.launch.train import make_compute_policy
    from repro_torch.models import resnet as R
    from repro_torch.optim.sgd import sgd_momentum
    from repro_torch.tree import to_device

    dev = resolve_device(device)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    from repro_torch.core import engine_dist as ED
    group = own_group = None
    if sharded:
        import torch.distributed as dist
        own_group = not dist.is_initialized()
        group = ED.init_data_group(dev, pods=pods)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
    try:
        cfg = R.ResNetConfig(depth=depth, num_classes=num_clients,
                             width=width)
        tx, ty, ex, ey = make_synthetic_cifar(
            torch.Generator().manual_seed(seed), num_classes=num_clients,
            train_per_class=4 * batch_size, test_per_class=2 * batch_size,
            hw=hw, device=dev)
        data = partition_positive_labels(tx, ty, num_clients)
        split = E.make_resnet_split(cfg, policy=make_compute_policy(
            compute_dtype, use_kernel))
        opt = sgd_momentum(lr, momentum=0.9, weight_decay=5e-4)

        def run(scheme):
            st = to_device(E.init_dcml_state(
                torch.Generator().manual_seed(seed),
                lambda g: R.init(g, cfg), num_clients, opt, opt), dev)
            st, epoch, finish = _placed_epoch(
                scheme, group, st, data, split, opt,
                num_clients=num_clients, batch_size=batch_size,
                alpha=alpha, pipeline=pipeline, submesh=submesh, pods=pods,
                use_kernel=use_kernel, wire_dtype=wire_dtype,
                wire_dtype_bwd=wire_dtype_bwd, device=dev)
            gen = torch.Generator().manual_seed(seed + 1)
            t0 = time.perf_counter()
            for _ in range(epochs):
                st, _ = epoch(gen, st)
            st = finish(st)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            rmsd = scheme == "sflv2"
            return {
                "iid": evaluate_split_iid(st, split, ex, ey, num_clients,
                                          rmsd=rmsd, batch=2 * batch_size),
                "noniid": evaluate_split_noniid(st, split, ex, ey,
                                                num_clients, rmsd=rmsd,
                                                batch=2 * batch_size),
                "seconds": seconds,
            }

        return {"sfpl": run("sfpl"), "sflv2": run("sflv2"),
                "num_clients": num_clients, "sharded": sharded}
    finally:
        if own_group:
            ED.close_data_group()


def _placed_epoch(scheme, group, st, data, split, opt, *, num_clients,
                  batch_size, alpha, pipeline, submesh, pods, use_kernel,
                  wire_dtype, wire_dtype_bwd, device):
    """``(st, epoch, finish)`` of one scheme on its placement: the state
    the epochs take (this rank's share where the clients are split),
    ``epoch(gen, st) -> (st, losses)``, and ``finish(st)``, the whole
    state again. One device: SFPL's collector runs the shuffle through
    the ``collector_permute`` kernel with ``use_kernel``."""
    from repro_torch.core import engine as E
    from repro_torch.core import round as RD
    common = dict(num_clients=num_clients, batch_size=batch_size,
                  device=device)
    same = lambda s: s
    if group is None:
        if scheme == "sfpl":
            coll = RD.SINGLE.collector(num_clients, alpha=alpha,
                                       use_kernel=use_kernel)
            return st, lambda g, s: RD.sfpl_round(
                g, s, data, split, opt, opt, collector=coll, **common), same
        return st, lambda g, s: E.sflv2_epoch(
            g, s, data, split, opt, opt, **common), same
    from repro_torch.core import engine_dist as ED
    shards = ED.fit_shards(num_clients, batch_size, scheme=scheme,
                           alpha=alpha, collector_pipeline=pipeline,
                           collector_submesh=submesh, pods=pods,
                           max_shards=group.world, wire_dtype=wire_dtype,
                           wire_dtype_bwd=wire_dtype_bwd)
    if shards != group.world:
        raise ValueError(
            f"{scheme} with {num_clients} clients x batch {batch_size} at "
            f"alpha {alpha} ({pipeline}, submesh={submesh}, pods={pods}) "
            f"splits over at most {shards} of the {group.world} ranks: run "
            f"with --nproc_per_node {shards}, or change --clients / "
            f"--alpha")
    if scheme == "sflv2":
        return st, lambda g, s: ED.sflv2_epoch_sharded(
            g, s, data, split, opt, opt, group=group, **common), same
    local = ED.shard_client_data(data, group)
    return (ED.shard_dcml_state(st, group),
            lambda g, s: ED.sfpl_epoch_sharded(
                g, s, local, split, opt, opt, group=group, alpha=alpha,
                use_kernel=use_kernel, collector_pipeline=pipeline,
                collector_submesh=submesh, wire_dtype=wire_dtype,
                wire_dtype_bwd=wire_dtype_bwd, **common),
            lambda s: ED.gather_clients(s, group))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paper", action="store_true",
                    help="SFPL vs SFLv2 at matched fleet size")
    ap.add_argument("--arch", default="qwen3-8b", help="LM mode")
    ap.add_argument("--batches", type=int, default=8, help="LM mode")
    ap.add_argument("--seq", type=int, default=64,
                    help="LM mode: tokens a sequence (whisper's smoke "
                         "decoder has 32 learned positions)")
    ap.add_argument("--ckpt", help="LM mode: a launch.train --ckpt file")
    ap.add_argument("--sharded", action="store_true",
                    help="run both schemes over the process group's ranks")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--pipeline", default="sync",
                    choices=("sync", "double_buffered"),
                    help="sharded SFPL collector pipeline")
    ap.add_argument("--submesh", dest="submesh", action="store_true",
                    default=None,
                    help="force sub-mesh streaming on (default: on when "
                         "the balanced grouped layout qualifies)")
    ap.add_argument("--no-submesh", dest="submesh", action="store_false",
                    help="force the whole-mesh streaming fallback")
    ap.add_argument("--pods", type=int, default=None,
                    help="lay the sharded ranks out as this many pods")
    ap.add_argument("--use-kernel", dest="use_kernel", action="store_true",
                    default=None, help="force the kernels on (default: on "
                    "when the device is CUDA)")
    ap.add_argument("--no-kernel", dest="use_kernel", action="store_false")
    ap.add_argument("--compute-dtype", dest="compute_dtype",
                    default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--wire-dtype", dest="wire_dtype", default=None,
                    help="sharded SFPL: wire dtype of the smashed rows "
                         "(float32, bfloat16, int8 or float8_e4m3)")
    ap.add_argument("--wire-dtype-bwd", dest="wire_dtype_bwd", default=None,
                    help="sharded SFPL: wire dtype of the routed-back "
                         "gradient rows")
    ap.add_argument("--device", default=None,
                    help="default: cuda (raises without CUDA)")
    args = ap.parse_args(argv)
    if not args.paper:
        return _main_lm(args)
    rep = evaluate_paper(num_clients=args.clients, epochs=args.epochs,
                         sharded=args.sharded, alpha=args.alpha,
                         pipeline=args.pipeline, submesh=args.submesh,
                         pods=args.pods, use_kernel=args.use_kernel,
                         compute_dtype=args.compute_dtype,
                         wire_dtype=args.wire_dtype,
                         wire_dtype_bwd=args.wire_dtype_bwd,
                         device=args.device)
    if int(os.environ.get("RANK", "0")):
        return
    chance = 100.0 / args.clients
    print(f"matched fleet ({args.clients} clients, "
          f"sharded={args.sharded}, chance {chance:.1f}%):")
    for scheme in ("sfpl", "sflv2"):
        r = rep[scheme]
        print(f"  {scheme:5s}  IID test {r['iid']['accuracy']:5.1f}%  "
              f"non-IID test {r['noniid']['accuracy']:5.1f}%")


def _main_lm(args):
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    spec = get_arch(args.arch)
    cfg = spec.make_smoke_config()
    dev = resolve_device(args.device)
    params = spec.model.init(
        torch.Generator(device=dev).manual_seed(0), cfg)
    if args.ckpt:
        params, step = restore_checkpoint(args.ckpt, params)
        print(f"restored step {step}")
    m = evaluate_lm(spec, cfg, params, batches=args.batches, seq=args.seq)
    print(f"{args.arch}: loss {m['loss']:.4f}  ppl {m['ppl']:.1f}  "
          f"token-acc {m['token_accuracy']:.3f}")


if __name__ == "__main__":
    main()
