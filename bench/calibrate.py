#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from, at the cell's
own size, all in one process:

* the program's compared numbers over ``--seeds`` seeds (the lower
  readings);
* the control's and the planted faults' over ``--control-seeds``
  seeds: the reference put in the program's place with each entry of the
  cell's program module's ``FAULTS`` (``bench/programs/<model.arch>.py``).
  For the split ResNet: ``control``, the reference computed with fp8
  products (``reference.Precision("fp8")``), one step below the
  configuration's bfloat16; the reference with half of the pool left out
  of the server's step, its mean taken over the rest: the second half of
  the clients' rows (``half_batch``), or the second half of the shuffled
  rows (``half_rows``); the bfloat16 witness, the reference with bfloat16
  products and activations (``bf16_witness``); and a state left
  unchanged (``frozen``).

    python bench/calibrate.py --workload r56_c100.train_b128 --seeds 12 \
        --control-seeds 3 --first-seed 1000 --out cal.json

It prints one JSON line of readings and writes it to ``--out``. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))


def free(dev):
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def readings(workload, seeds, control_seeds, device="cuda", root=None):
    """``{"program": [...], <each key of the program module's FAULTS>:
    [...]}``, each a list of ``{"seed", numbers...}``."""
    import torch

    from bench import run, spec

    cell = spec.Cell(workload, root)
    program = cell.program()
    dev = torch.device(device)
    out = {"program": [], **{key: [] for key in program.FAULTS}}
    for s in seeds:
        t = time.perf_counter()
        run.build_kernels(dev)
        runner, got = program.checked(cell, s, dev)
        runner.free()
        del runner
        free(dev)
        want = program.reference(cell, s, dev)
        out["program"].append({"seed": s, **program.numbers(got, want),
                               "seconds": time.perf_counter() - t})
        print(json.dumps({"program": out["program"][-1]}), file=sys.stderr,
              flush=True)
        free(dev)
    for s in control_seeds:
        want = program.reference(cell, s, dev)
        for key, kw in program.FAULTS.items():
            got = program.reference(cell, s, dev, **kw)
            out[key].append({"seed": s, **program.numbers(got, want)})
            print(json.dumps({key: out[key][-1]}), file=sys.stderr,
                  flush=True)
            free(dev)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    from bench import run
    run.set_cache_dirs(HERE.parent)
    seeds = [args.first_seed + i for i in range(args.seeds)]
    control = [args.first_seed + 10_000 + i
               for i in range(args.control_seeds)]
    res = {"workload": args.workload,
           **readings(args.workload, seeds, control, args.device)}
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
