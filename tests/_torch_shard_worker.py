"""One rank of the sharded LM's multi-rank test
(``tests/test_torch_sharding.py``).

    python tests/_torch_shard_worker.py <job.pkl> <rank>

The job (written by the test in its temporary directory) names the world
size, a ``FileStore`` path, the mesh shape and a list of cases. Every rank
joins a gloo group, lays the mesh out as ``("data", "model")`` and runs
each case with the parameters, batch and state as DTensors laid out by
``repro_torch.sharding``; it writes ``<job dir>/rank<r>.pkl`` with each
case's gathered outputs. The test computes the same cases on one device
with :func:`run_case` and plain tensors.

A case is ``{"arch", "kind", "overrides"}``, kind one of ``prefill``,
``decode`` (two steps from an empty state; whisper's cross K / V filled
from its encoder first) and ``train`` (one SGD-momentum step, with the
collector permutation for the transformer family).
"""
import pickle
import sys
import traceback

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, sharded_scope)
from repro_torch.optim import sgd_momentum
from repro_torch.tree import tree_map

B, S, FRAMES = 4, 16, 16


def make_inputs(seed=0):
    """The cases' inputs, from a numpy generator."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, 512, (B, S)).astype(np.int32),
            "labels": rng.integers(0, 512, (B, S)).astype(np.int32),
            "frame_embeds": rng.standard_normal((B, FRAMES, 128))
            .astype(np.float32),
            "perm": rng.permutation(B).astype(np.int64)}


def case_config(case, mesh_axes=None):
    spec = get_arch(case["arch"])
    return spec, spec.make_smoke_config(mesh_axes=mesh_axes,
                                        **case.get("overrides", {}))


def _full(t):
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    return t.detach().numpy()


def run_case(case, inputs, mesh=None):
    """The case's outputs as numpy arrays. With ``mesh`` (a DeviceMesh)
    the params, batch and state are DTensors laid out by the rules."""
    from repro_torch.sharding import rules as R
    mesh_axes = R.mesh_axes_of(mesh) if mesh is not None else None
    spec, cfg = case_config(case, mesh_axes)
    model = spec.model
    params = model.init(torch.Generator().manual_seed(0), cfg)
    lay = (lambda tree, shard: R.distribute(tree, shard(tree, mesh))) \
        if mesh is not None else (lambda tree, shard: tree)
    params = lay(params, R.param_shardings)
    toks = torch.from_numpy(inputs["tokens"])
    batch = {"tokens": toks}
    if spec.family == "whisper":
        batch["frame_embeds"] = torch.from_numpy(inputs["frame_embeds"])
    kind = case["kind"]
    if kind == "prefill":
        logits = make_prefill_step(spec, cfg)(
            params, lay(batch, R.batch_shardings))
        return {"logits": _full(logits)}
    if kind == "decode":
        kw = {"dtype": torch.float32}
        if spec.family == "whisper":
            kw["enc_frames"] = FRAMES
        state = model.init_decode_state(cfg, B, S, **kw)
        if spec.family == "whisper":
            fe = lay({"f": batch["frame_embeds"]}, R.batch_shardings)["f"]
            with sharded_scope(params):
                enc = model.encode(params, fe, cfg)
                state = model.prefill_cross(params, enc, state, cfg)
            state = tree_map(lambda t: t.full_tensor() if hasattr(
                t, "full_tensor") else t, state)
        state = lay(state, R.state_shardings)
        step = make_decode_step(spec, cfg)
        out = {}
        for p in range(2):
            tok = lay({"t": toks[:, p:p + 1].contiguous()},
                      R.batch_shardings)["t"]
            logits, state = step(params, state, tok, p)
            out[f"logits{p}"] = _full(logits)
        return out
    batch["labels"] = torch.from_numpy(inputs["labels"])
    batch = lay(batch, R.batch_shardings)
    sfpl = spec.family == "transformer"
    if sfpl:
        batch["perm"] = torch.from_numpy(inputs["perm"])
    opt = sgd_momentum(0.1, momentum=0.9)
    new_p, new_s, _, loss = make_train_step(spec, cfg, opt, sfpl=sfpl)(
        params, opt.init(params), 0, batch)
    out = {"loss": _full(loss)}
    out.update({f"p/{k}": v for k, v in _flat(new_p).items()})
    out.update({f"mu/{k}": v for k, v in _flat(new_s["mu"]).items()})
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: _full(tree)}


def main(job_path, rank):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    torch.set_num_threads(1)     # the ranks share the host's cores
    dist.init_process_group(
        "gloo", store=dist.FileStore(job["store"], job["world"]),
        rank=rank, world_size=job["world"])
    mesh = init_device_mesh("cpu", tuple(job["mesh"]),
                            mesh_dim_names=("data", "model"))
    results = []
    try:
        for case in job["cases"]:
            try:
                results.append({"ok": run_case(case, job["inputs"], mesh)})
            except Exception:   # reported per case; the test asserts on it
                results.append({"error": traceback.format_exc()})
    finally:
        dist.destroy_process_group()
    with open(f"{job['out']}/rank{rank}.pkl", "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
