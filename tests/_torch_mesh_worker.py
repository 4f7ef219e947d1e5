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
  * ``stream``: the double-buffered collector's epoch
    (``sfpl_epoch_sharded(collector_pipeline="double_buffered")``, or
    ``round.sfpl_round`` itself for a mask that drops a whole flush
    group), optionally on a pod layout, beside the sync epoch from the
    same generator; returns both losses, the streamed final state, the
    first step's permutation and its exchange and re-layout bytes.
  * ``shuffle``: ``streamed_shuffle`` of this rank's slab of a pool and
    ``route_back`` of the result.
  * ``sflv2``: ``sflv2_epoch_sharded`` over the whole (replicated) state
    with a given visit order.
"""
import pickle
import sys
import traceback

import numpy as np
import torch

from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.core import engine as E
from repro_torch.core import engine_dist as ED
from repro_torch.core import round as RD
from repro_torch.models import resnet as R
from repro_torch.models.common import ComputePolicy
from repro_torch.optim import sgd_momentum
from repro_torch.tree import tree_map


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


def _setup(job, clients=None):
    cfg = R.ResNetConfig(depth=8, num_classes=job["num_classes"],
                         width=job["width"])
    split = E.make_resnet_split(cfg)
    opt = sgd_momentum(job["lr"], momentum=0.9, weight_decay=5e-4)
    st = from_jax_numpy(job["state"])
    data = {"x": torch.from_numpy(job["data"]["x"]),
            "y": torch.from_numpy(job["data"]["y"]).long()}
    return split, opt, st, data


def _stream(job, case, group):
    split, opt, st0, data0 = _setup(job)
    place = group if case.get("pods") is None else \
        ED.make_pod_layout(group, case["pods"])
    st, data = ED.shard_dcml_state(st0, place), \
        ED.shard_client_data(data0, place)
    n_clients, batch = job["num_clients"], job["batch"]
    kw = dict(num_clients=n_clients, batch_size=batch, device="cpu")
    part = case.get("participation")
    coll = place.collector(n_clients, alpha=case["alpha"],
                           mode=case["mode"], pipeline="double_buffered",
                           submesh=case.get("submesh"),
                           wire_dtype=case.get("wire"),
                           wire_dtype_bwd=case.get("wire_bwd"))
    gen = lambda: torch.Generator().manual_seed(case["seed"])
    if part is not None:
        # a mask that drops a whole flush group passes no layout check:
        # the round itself, as the reference's test of the skip does
        st_s, losses = RD.sfpl_round(gen(), st, data, split, opt, opt,
                                     collector=coll,
                                     participation=torch.from_numpy(part),
                                     **kw)
        sync = RD.sfpl_round(gen(), st, data, split, opt, opt,
                             collector=place.collector(
                                 n_clients, alpha=case["alpha"],
                                 mode=case["mode"]),
                             participation=torch.from_numpy(part), **kw)[1]
    else:
        common = dict(alpha=case["alpha"], collector_mode=case["mode"],
                      wire_dtype=case.get("wire"),
                      wire_dtype_bwd=case.get("wire_bwd"), **kw)
        st_s, losses = ED.sfpl_epoch_sharded(
            gen(), st, data, split, opt, opt, group=place,
            collector_pipeline="double_buffered",
            collector_submesh=case.get("submesh"), **common)
        sync = ED.sfpl_epoch_sharded(gen(), st, data, split, opt, opt,
                                     group=place, **common)[1]
    n = n_clients * batch
    perm = coll.make_perm(gen(), n)
    prep = coll.prepare(perm, n)
    row = int(np.prod(job["data"]["x"].shape[2:-1])) * job["width"]
    return {"losses": losses.numpy(), "sync": sync.numpy(),
            "state": to_numpy(st_s), "perm": perm.numpy(),
            "submesh": coll.submesh_slices(n),
            "bytes": coll.exchange_bytes(prep, row, torch.float32),
            "relayout_bytes": coll.relayout_bytes(prep, row, torch.float32)}


def _shuffle(job, case, group):
    x = torch.from_numpy(case["x"])
    n = x.shape[0]
    coll = group.collector(job["num_clients"], alpha=case["alpha"],
                           mode=case["mode"], pipeline="double_buffered",
                           submesh=case.get("submesh"))
    prep = coll.prepare(torch.from_numpy(case["perm"]), n)
    slab = group.local(x)
    if coll.submesh_slices(n) is not None:
        produce = lambda g: slab
    else:
        produce = lambda g: slab[slice(*coll.home_rows(n, g))]
    out = RD.streamed_shuffle(coll, prep, n, produce)
    back = coll.route_back(out, prep, n)
    return {"out": out.numpy(), "back": back.numpy()}


def _sflv2(job, case, group):
    split, opt, st, data = _setup(job)
    k, steps = case["clients"], case["steps"]
    cut = lambda a: a[:k]
    st = dict(st, **{key: tree_map(cut, st[key])
                     for key in ("cp", "cbn", "copt")})
    data = {key: v[:k, :steps * job["batch"]] for key, v in data.items()}
    RD.visit_order = lambda gen, num: list(case["order"])
    st, losses = ED.sflv2_epoch_sharded(
        None, st, data, split, opt, opt, group=group, num_clients=k,
        batch_size=job["batch"], device="cpu")
    return {"losses": losses.numpy(), "state": to_numpy(st)}


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
                       "overflow": _epoch, "stream": _stream,
                       "shuffle": _shuffle, "sflv2": _sflv2}[case["kind"]]
                results.append({"ok": run(job, case, group)})
            except Exception:   # reported per case; the test asserts on it
                results.append({"error": traceback.format_exc()})
    finally:
        ED.close_data_group()
    with open(f"{job['out']}/rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
