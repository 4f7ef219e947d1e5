#!/usr/bin/env python3
"""Rounding against depth: the float32 reference and the program's
float32 path, each against the reference in float64, over the checked
steps, on the CPU at a small pool.

It shows where the worst-leaf numbers' gaps come from: if the float32
reference alone departs from float64 as far as the program does, and
the gap grows smoothly with depth, rounding amplified by the deep
network is the cause, not a fault of the program's repeated blocks.

    python bench/depth_witness.py --depths 8,14,20,32,56 --seeds 1,2,3

One JSON line a depth and seed: ``ref32`` (reference float32 against
float64), ``prog32`` (program float32 against reference float64).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))

KEYS = ("loss_gap", "head_grad_err", "grad_median_gap", "grad_gap",
        "update_median_gap", "update_gap")


class _Cell:
    """A cell of ResNet-``depth`` at the configuration's widths and
    optimizer, float32 compute, ``clients`` x ``batch``."""

    def __init__(self, config, depth, clients, batch):
        self.config = json.loads(json.dumps(config))
        self.config["model"].update(depth=depth, num_classes=clients)
        self.config["deployment"].update(clients=clients,
                                         samples_per_client=3 * batch)
        self.config["precision"]["compute_dtype"] = "float32"
        self.traffic = {"client_batch": batch, "check_epochs": [1, 2]}


def reference(cell, seed, dtype):
    import torch

    from bench import reference as R
    from bench import run
    dev = torch.device("cpu")
    batch = cell.traffic["client_batch"]
    data = run.make_data(cell, seed, dev)
    data["x"] = data["x"][:, :3 * batch].to(dtype)
    params = {k: v.to(dtype) for k, v in R.init_params(
        torch.Generator(dev).manual_seed(run.sub_seed(seed, 1)),
        cell.config["model"]).items()}
    losses, mu, var, out = R.run_epochs(
        params, cell.config["model"], cell.config["optimizer"], data, batch,
        torch.Generator().manual_seed(run.sub_seed(seed, 2)), [1, 2])
    return {"losses": losses, "first_mu": mu, "first_var": var,
            "start": R.stacked(params, data["x"].shape[0]), "params": out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="sfpl-resnet56-cifar100")
    ap.add_argument("--depths", default="8,14,20,32,56")
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--clients", type=int, default=10)
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args(argv)
    import torch

    from bench import compare as C
    from bench import run
    config = json.loads((HERE / "configs" / f"{args.config}.json")
                        .read_text())
    for depth in map(int, args.depths.split(",")):
        cell = _Cell(config, depth, args.clients, args.batch)
        for seed in map(int, args.seeds.split(",")):
            want = reference(cell, seed, torch.float64)
            ref32 = C.numbers(reference(cell, seed, torch.float32), want)
            prog = run.checked_program(cell, seed, torch.device("cpu"))[-1]
            prog32 = C.numbers(prog, want)
            print(json.dumps({"depth": depth, "seed": seed,
                              "ref32": {k: ref32[k] for k in KEYS},
                              "prog32": {k: prog32[k] for k in KEYS}}),
                  flush=True)


if __name__ == "__main__":
    main()
