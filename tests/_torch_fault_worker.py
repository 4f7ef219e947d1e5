"""One rank of the port's kill-and-resume test (tests/test_torch_multihost.py).

``run`` is the target of a ``torch.multiprocessing`` spawn: it joins the
process group through ``launch.multihost.initialize`` (gloo over a
``file://`` FileStore), runs the sharded SFPL epochs of a 4-client world
(2 clients a rank, alpha 0.5) under a seeded ``FaultPlan`` with dropouts
every epoch, and writes ``<out>/rank<r>.pkl``. It imports the port and
PyTorch only.

Modes: "full" runs every epoch uninterrupted; "fault" saves the full
training state after each epoch (gathered on every rank, written by rank
0, then a barrier so that the file is on disk before any rank goes on)
and the plan's ``kill_process`` SIGKILLs itself at the start of
``kill_epoch``; "resume" restores that state and finishes the run.
"""
import pickle

import numpy as np
import torch

from repro_torch import checkpoint as CK
from repro_torch.core import engine as E
from repro_torch.core import engine_dist as ED
from repro_torch.core.faults import FaultPlan, ensure_group_survivor
from repro_torch.data import make_synthetic_cifar, partition_positive_labels
from repro_torch.launch import multihost
from repro_torch.models import resnet as R
from repro_torch.optim import sgd_momentum
from repro_torch.tree import tree_leaves

V, B, EPOCHS, ALPHA = 4, 2, 3, 0.5
KILL = dict(kill_process=1, kill_epoch=2)


def run(rank, world, init_url, mode, ckpt, out):
    torch.set_num_threads(1)
    multihost.initialize(init_url, world, rank, backend="gloo",
                         timeout_s=60)
    group = ED.init_data_group("cpu")
    try:
        _epochs(group, rank, mode, ckpt, out)
    finally:
        ED.close_data_group()


def _epochs(group, rank, mode, ckpt, out):
    import torch.distributed as dist
    cfg = R.ResNetConfig(depth=8, num_classes=V, width=8)
    gen = torch.Generator().manual_seed(0)
    tx, ty, _, _ = make_synthetic_cifar(gen, num_classes=V,
                                        train_per_class=2 * B,
                                        test_per_class=1, hw=8)
    data = ED.shard_client_data(partition_positive_labels(tx, ty, V), group)
    split = E.make_resnet_split(cfg)
    opt = sgd_momentum(0.05, momentum=0.9, weight_decay=5e-4)
    st = E.init_dcml_state(gen, lambda g: R.init(g, cfg), V, opt, opt)
    plan = FaultPlan(V, seed=3, drop_rate=0.25,
                     **(KILL if mode == "fault" else {}))

    draws = torch.Generator().manual_seed(1)
    start = 0
    if mode == "resume":
        st, state, start = CK.restore_train_state(ckpt, st)
        draws.set_state(state)
    st = ED.shard_dcml_state(st, group)
    losses, masks = {}, {}
    for ep in range(start, EPOCHS):
        plan.maybe_kill(rank, ep)
        mask, _ = plan.participation(ep)
        mask, _ = ensure_group_survivor(mask, V, alpha=ALPHA)
        masks[ep] = mask
        st, ls = ED.sfpl_epoch_sharded(
            draws, st, data, split, opt, opt, group=group, num_clients=V,
            batch_size=B, alpha=ALPHA, participation=torch.from_numpy(mask),
            device="cpu")
        losses[ep] = multihost.host_value(ls)
        if mode == "fault":
            # a collective gather on every rank; rank 0 writes
            CK.save_train_state(ckpt, ED.gather_clients(st, group),
                                gen=draws, epoch=ep + 1)
            dist.barrier()
    result = {
        "start": start, "losses": losses, "masks": masks,
        "cp": [multihost.host_value(x, sharded=True)
               for x in tree_leaves(st["cp"])],
        "sp": [multihost.host_value(x) for x in tree_leaves(st["sp"])],
        "sopt": [multihost.host_value(x) for x in tree_leaves(st["sopt"])]}
    with open(f"{out}/rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)
    assert all(np.isfinite(v).all() for v in losses.values())
