"""One rank of the port's multi-rank tests (``tests/test_torch_mesh.py``).

    python tests/_torch_mesh_worker.py <job.pkl> <rank>

The job (written by the test, in the test's own temporary directory)
names the world size, a ``FileStore`` path and a list of cases; every rank
runs them all in order on the CPU over gloo and writes
``<job dir>/rank<r>.pkl`` with one result per case. It imports the port
and PyTorch only: the JAX oracle is computed by the test process.

Cases:
  * ``epoch``: ``engine_dist.sfpl_epoch_sharded`` on this rank's share of
    the state and data; returns the losses and the final state (client
    leaves for this rank's block only).
  * ``exchange``: ``plan_shuffle`` of this rank's slab of a pool under a
    given permutation and wire, and the gradient of a weighted sum back
    through the backward plan.
  * ``overflow``: an epoch whose uniform buckets are too small; returns
    the error text (every rank must raise it, none may hang).
"""
import pickle
import sys
import traceback

import numpy as np
import torch

from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.core import engine as E
from repro_torch.core import engine_dist as ED
from repro_torch.models import resnet as R
from repro_torch.models.common import ComputePolicy
from repro_torch.optim import sgd_momentum


def _epoch(job, case, group):
    cfg = R.ResNetConfig(depth=8, num_classes=job["num_classes"],
                         width=job["width"])
    policy = (ComputePolicy(case["compute_dtype"], use_fused_kernels=True)
              if case.get("compute_dtype") else None)
    split = E.make_resnet_split(cfg, policy=policy)
    opt = sgd_momentum(job["lr"], momentum=0.9, weight_decay=5e-4)
    st = ED.shard_dcml_state(from_jax_numpy(job["state"]), group)
    data = ED.shard_client_data(
        {"x": torch.from_numpy(job["data"]["x"]),
         "y": torch.from_numpy(job["data"]["y"]).long()}, group)
    part = case.get("participation")
    st, losses = ED.sfpl_epoch_sharded(
        torch.Generator().manual_seed(case["seed"]), st, data, split, opt,
        opt, group=group, num_clients=job["num_clients"],
        batch_size=job["batch"], alpha=case["alpha"],
        collector_mode=case["mode"], slack=case.get("slack"),
        check_capacity=case.get("check_capacity", False),
        wire_dtype=case.get("wire"), wire_dtype_bwd=case.get("wire_bwd"),
        participation=None if part is None else torch.from_numpy(part),
        device="cpu")
    return {"losses": losses.numpy(), "state": to_numpy(st)}


def _exchange(job, case, group):
    x = torch.from_numpy(case["x"]).to(getattr(torch, case["dtype"]))
    perm = torch.from_numpy(case["perm"])
    coll = group.collector(job["num_clients"], mode=case["mode"],
                           wire_dtype=case.get("wire"),
                           wire_dtype_bwd=case.get("wire_bwd"))
    prep = coll.prepare(perm, perm.shape[0])
    x_loc = group.local(x).clone().requires_grad_()
    out = coll.permute(x_loc, prep)
    w = group.local(torch.from_numpy(case["w"]).to(out.dtype))
    (gx,) = torch.autograd.grad((out.float() * w.float()).sum(), x_loc)
    y_loc = coll.permute(group.local(torch.from_numpy(case["labels"])), prep)
    return {"out": out.detach().float().numpy(), "grad": gx.float().numpy(),
            "labels": y_loc.numpy(), "dtype": str(out.dtype),
            "bytes": coll.exchange_bytes(prep, int(np.prod(x.shape[1:])),
                                         x.dtype)}


def main(job_path, rank):
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(1)     # the ranks share the host's cores
    group = ED.init_data_group("cpu", store=job["store"], rank=rank,
                               world_size=job["world"], timeout_s=60)
    results = []
    try:
        for case in job["cases"]:
            try:
                run = {"epoch": _epoch, "exchange": _exchange,
                       "overflow": _epoch}[case["kind"]]
                results.append({"ok": run(job, case, group)})
            except Exception:   # reported per case; the test asserts on it
                results.append({"error": traceback.format_exc()})
    finally:
        ED.close_data_group()
    with open(f"{job['out']}/rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
