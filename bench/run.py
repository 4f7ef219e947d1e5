#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line.

    python bench/run.py --workload r56_c100.train_b128 --seed 7 \
        --seconds 20 --trace 0

One run, from the root of a checkout, drives the cell's program module,
``bench/programs/<model.arch>.py`` (``spec.py`` states its contract; for
the split ResNet a unit is one SFPL epoch):

1. set-up (``setup_s``): import the port, build its kernels (cached in
   ``build/kernels/`` and ``build/triton/`` of the checkout), then the
   module's ``checked``: for the split ResNet, make the cell's images and
   weights on the card from ``--seed``, build the SFPL state, and drive
   it through the checked first steps (``check_epochs`` of the traffic
   file: one step, then two, FedAvg after each) through the same
   ``sfpl_round`` and data that the window uses; those steps warm every
   shape the window runs;
2. the window: whole units back to back from that state until
   ``--seconds`` have passed, then a synchronise (``--trace 1``: then
   the traffic's ``trace_epochs`` units twice under the profiler, once
   with the CUDA activity alone for the device's busy time, once with
   operator rows and shapes too);
3. the check: the program's state is freed, the module's plain reference
   (the split ResNet's: ``reference.py``) follows the checked steps from
   the same weights, data and permutations, and its ``numbers`` (the
   split ResNet's: ``compare.py``) are set beside the cell's limits.

The last line of standard output is the result as one JSON object; the
numbers compared are the last lines of standard error. Without a card, or
with fewer cards than the cell asks for, or where the cell's ``model.arch``
has no program module, it prints no result and exits 1.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# import the harness as the package ``bench``, never its files by bare name
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names):
    """Top-level names among ``names`` (module names, dotted) that are
    JAX or the JAX package, compared whole: ``repro_torch`` is not
    ``repro``."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def sub_seed(seed, k):
    """The ``k``-th stream of ``seed``: images 0, weights 1, shuffles 2."""
    return (int(seed) * 0x9E3779B97F4A7C15 + k * 0xBF58476D1CE4E5B9) \
        % (2 ** 63)


def set_cache_dirs(root):
    """Kernel and compile caches at fixed places inside the checkout."""
    build = Path(root) / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def checked_program(cell, seed, dev):
    """Set the program up for a cell and drive it through the checked
    steps (``check_epochs``: one step, then two, FedAvg after each)
    through the same call and data that the window uses. Returns
    ``(program, state, data, shuffle generator, outputs)``, the outputs
    being ``{"losses", "first_mu", "first_var", "start", "params"}``."""
    import torch

    from bench import reference as R
    from bench import sut

    sut.import_program()
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    prog = sut.Program(cell.config, cell.traffic, dev)
    data = make_data(cell, seed, dev)
    gen = torch.Generator(dev).manual_seed(sub_seed(seed, 1))
    st = prog.init_state(R.init_params(gen, cell.config["model"]))
    start = {k: v.detach().clone() for k, v in sut.params_of(st).items()}
    perm_gen = torch.Generator().manual_seed(sub_seed(seed, 2))
    batch = cell.traffic["client_batch"]
    if cell.traffic["check_epochs"][0] != 1:
        raise ValueError("check_epochs must start with a one-step epoch: "
                         "the first gradient is read from its momentum")
    losses, first_mu, first_var, at = [], None, None, 0
    for n in cell.traffic["check_epochs"]:
        part = {k: v[:, at * batch:(at + n) * batch] for k, v in
                data.items()}
        before = sut.server_bn_var(st)
        st, ls = prog.epoch(perm_gen, st, part)
        losses += [float(v) for v in ls.float().cpu()]
        if first_mu is None:
            first_mu = {k: v.detach().clone()
                        for k, v in sut.momentum_of(st).items()}
            # the batch variance each server BatchNorm saw in that step
            m = R.MOMENTUM
            first_var = {k: (v - m * before[k]) / (1 - m)
                         for k, v in sut.server_bn_var(st).items()}
        at += n
    out = {"losses": losses, "first_mu": first_mu, "first_var": first_var,
           "start": start,
           "params": {k: v.detach().clone()
                      for k, v in sut.params_of(st).items()}}
    return prog, st, data, perm_gen, out


def make_data(cell, seed, dev):
    """The cell's images, made on ``dev`` from ``seed``."""
    import torch

    from bench import images
    model, dep = cell.config["model"], cell.config["deployment"]
    gen = torch.Generator(dev).manual_seed(sub_seed(seed, 0))
    return images.positive_label_cifar(gen, dep["clients"],
                                       dep["samples_per_client"],
                                       model["image_hw"],
                                       model["in_channels"])


def checked_reference(cell, seed, dev, precision="float32",
                      drop_half=None, frozen=False):
    """The plain reference through the checked steps, from the same
    seed: ``{"losses", "first_mu", "first_var", "start", "params"}``.
    ``precision``
    "fp8" is the control; ``drop_half`` and ``frozen`` plant faults."""
    import torch

    from bench import reference as R
    model = cell.config["model"]
    batch = cell.traffic["client_batch"]
    check = cell.traffic["check_epochs"]
    data = {k: v[:, :sum(check) * batch] for k, v in
            make_data(cell, seed, dev).items()}
    params = R.init_params(torch.Generator(dev).manual_seed(
        sub_seed(seed, 1)), model)
    losses, mu, var, out = R.run_epochs(
        params, model, cell.config["optimizer"], data, batch,
        torch.Generator().manual_seed(sub_seed(seed, 2)), check,
        precision=precision, drop_half=drop_half, frozen=frozen)
    return {"losses": losses, "first_mu": mu, "first_var": var,
            "start": R.stacked(params, cell.config["deployment"]["clients"]),
            "params": out}


def build_kernels(dev):
    """On a card, the port's kernels, built once a run (cached in the
    checkout) before any program module sets up."""
    if dev.type == "cuda":
        from bench import sut
        sut.import_program()
        from repro_torch.kernels import build
        build.build_all()


def execute(workload, seed, seconds, trace, device="cuda", root=None,
            t0=None):
    """One run of a cell on ``device``, driven through the cell's program
    module (``spec.Cell.program``): ``(result, checks)``."""
    import torch

    from bench import compare as C
    from bench import spec

    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.Cell(workload, root)
    traffic = cell.traffic
    program = cell.program()
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    build_kernels(dev)
    runner, prog_out = program.checked(cell, seed, dev)
    sync()
    setup_s = time.perf_counter() - t0

    # the window
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    window_losses, units, result = [], 0, {}
    sync()
    w0 = time.perf_counter()
    while True:
        window_losses.append(runner.unit())
        units += 1
        if time.perf_counter() - w0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - w0
    samples = units * runner.samples_per_unit
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    # a cell that host dispatch paces reads this rate per layer instead
    # (``host.samples_per_s``): the host's speed moves it too far
    e2e = {"train_samples_per_s": samples / window_s,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
               for m in cell.end_to_end()}
    device_extra = {}
    if trace:
        # then whole units under the profiler, from the same state: the
        # device pass, then the full pass
        from bench import tracing as TR

        def traced():
            for _ in range(traffic["trace_epochs"]):
                window_losses.append(runner.unit())
        n = traffic["trace_epochs"]
        busy = TR.Busy(TR.profile(traced, full=False),
                       samples=n * runner.samples_per_unit)
        events = TR.profile(traced)
        tr = TR.Trace(events, cell=cell, steps=n * runner.steps_per_unit,
                      samples=n * runner.samples_per_unit, busy=busy)
        del events
        tr.window_rate = samples / window_s    # before the profiler
        metrics = {}
        for m in cell.per_layer():
            v = cell.reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["breakdown"] = tr.breakdown()
        print(json.dumps({"trace": tr.summary()}), file=sys.stderr)
        device_extra = {"busy_s": busy.busy_s, "window_s": busy.window_s}
        del tr
    allw = torch.cat([ls.float() for ls in window_losses])
    nonfinite = int((~torch.isfinite(allw)).sum())
    losses = prog_out["losses"]
    attempted = len(losses) + int(allw.numel())
    failed = nonfinite + sum(not math.isfinite(v) for v in losses)

    # the check, with the program's state freed
    runner.free()
    del runner, window_losses, allw
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    values = program.numbers(prog_out, program.reference(cell, seed, dev))
    values["nonfinite"] = nonfinite
    ok, checks = C.judge(values, cell.limits)
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak),
                   **device_extra}
    result = {"correct": bool(ok), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info, **result}
    return result, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def fail(msg):
        print(f"bench: {msg}", file=sys.stderr)
        sys.exit(1)

    from bench import spec
    try:
        cell = spec.Cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        fail(f"cannot find workload {args.workload!r}: {e}")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("no src/repro_torch in this checkout: nothing to measure")
    set_cache_dirs(ROOT)
    try:
        cell.program()
    except FileNotFoundError as e:
        fail(str(e))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the benchmark needs a card")
    if torch.cuda.device_count() < cell.entry["chips"]:
        fail(f"{torch.cuda.device_count()} card(s), the cell asks for "
             f"{cell.entry['chips']}")
    result, checks = execute(args.workload, args.seed, args.seconds,
                             args.trace, t0=T0)
    bad = forbidden_modules(sys.modules)
    if bad:
        fail(f"JAX or the JAX package was loaded: {bad}")
    result["checks"] = checks
    print(f"correct {result['correct']}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
