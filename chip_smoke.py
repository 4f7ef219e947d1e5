"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to account.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100:
the kernels are built for sm_90a). It builds the hand-written kernels from
``src/repro_torch/kernels``, checks each against its plain PyTorch version
at the main path's shapes, drives the SFPL trainer at full ResNet-56 width,
and prints, as its last line, ``{"ok": true, "device": {...}}``. Any failed
phase raises and the script exits non-zero without that line. Without
CUDA, or outside a checkout, it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM, dense rates (NVIDIA data sheet), at the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def fail(msg):
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def setup():
    if not (HERE / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the root of a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, str(HERE / "src"))
    return torch


torch = setup()

from repro_torch import kernels as K                          # noqa: E402
from repro_torch.kernels import build                         # noqa: E402
from repro_torch.kernels.bn_act import kernel as bn_k         # noqa: E402
from repro_torch.kernels.bn_act import ref as bn_ref          # noqa: E402
from repro_torch.kernels.collector_permute import kernel as perm_k  # noqa
from repro_torch.kernels.collector_permute import ref as perm_ref   # noqa
from repro_torch.kernels.softmax_xent import kernel as xent_k  # noqa: E402
from repro_torch.kernels.softmax_xent import ref as xent_ref   # noqa: E402

DEV = torch.device("cuda")
REPLACES = {
    "collector_permute": "src/repro/kernels/collector_permute/kernel.py:33",
    "bn_act": "src/repro/kernels/bn_act/kernel.py:30",
    "xent_fwd": "src/repro/kernels/softmax_xent/kernel.py:50",
    "xent_bwd": "src/repro/kernels/softmax_xent/kernel.py:79",
}
ROUTE = {"collector_permute": ("cuda", perm_k.SOURCE),
         "bn_act": ("cuda", bn_k.SOURCE),
         "xent_fwd": ("triton", xent_k.SOURCE),
         "xent_bwd": ("triton", xent_k.SOURCE)}


def phase(name):
    print(f"\n=== {name}", flush=True)


# --------------------------------------------------------------------------
# phase 1: device and toolchain

def device_and_build():
    phase("1. device and toolchain")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    nvcc = build.nvcc_path()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True,
                              timeout=60).stdout.strip().splitlines()[-1]
    triton = build.import_triton()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | nvcc "
          f"{nvcc_ver} | triton {triton.__version__} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _, nvcc_s, log = build.build_all()
    x = torch.randn(8, 100, device=DEV)
    y = torch.zeros(8, dtype=torch.int64, device=DEV)
    xent_k.xent_bwd(x, y, *xent_k.xent_fwd(x, y))
    torch.cuda.synchronize()
    print(f"build: nvcc {nvcc_s:.1f} s (all sources in parallel), "
          f"triton first launch included, total "
          f"{time.perf_counter() - t0:.1f} s; triton cache "
          f"{os.environ['TRITON_CACHE_DIR']}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())
    return smi


# --------------------------------------------------------------------------
# phase 2: every kernel against its plain version on the card

def time_ms(fn, iters=20, reps=5):
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph and replayed ``reps`` times between CUDA events, so host
    launch overhead is left out. Inputs stay the same from call to call
    (warm L2 where they fit in its 50 MB)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def eager_ms(fn, iters=20):
    """Time per call of ``iters`` back-to-back eager calls (CUDA events):
    device time or host launch overhead, whichever is larger."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(got, want, rel, atol):
    """max |got - want| and whether every element is within
    ``rel * |want| + atol``."""
    d = (got.double() - want.double()).abs()
    ok = bool((d <= rel * want.double().abs() + atol).all())
    return float(d.max()) if d.numel() else 0.0, ok


def ulp(dtype):
    return torch.finfo(dtype).eps


RESULTS = []


def record(name, shape, dtype, err, ok, tol, fn, plain, nbytes, flops,
           library=None):
    if not ok:
        raise AssertionError(f"{name} {tuple(shape)} {dtype}: kernel "
                             f"disagrees with its plain version (max err "
                             f"{err}, tol {tol})")
    b, by = bound_ms(nbytes, flops, dtype)
    row = dict(name=name, shape=list(shape), dtype=str(dtype).split(".")[-1],
               max_abs_err=err, tol=tol, ok=ok, ms=time_ms(fn),
               eager_ms=eager_ms(fn), plain_ms=time_ms(plain), bound_ms=b,
               bound_by=by,
               library_ms=None if library is None else time_ms(library))
    RESULTS.append(row)
    print(json.dumps(row), flush=True)


def check_permute(rows, feat, dtype):
    x = torch.randn((rows,) + feat, device=DEV).to(dtype)
    perm = torch.randperm(rows, device=DEV)
    got = perm_k.collector_permute(x, perm)
    want = perm_ref.collector_permute(x, perm)
    torch.cuda.synchronize()
    ok = torch.equal(got, want)
    err = float((got.float() - want.float()).abs().max())
    nbytes = 2 * x.numel() * x.element_size() + perm.numel() * 8
    record("collector_permute", x.shape, dtype, err, ok, "bitwise",
           lambda: perm_k.collector_permute(x, perm),
           lambda: perm_ref.collector_permute(x, perm), nbytes, 0,
           library=lambda: torch.index_select(x, 0, perm))


def check_bn_act(groups, rows, c, dtype, relu=True):
    x = torch.randn(groups, rows, c, device=DEV).to(dtype)
    a = torch.rand(groups, c, device=DEV) + 0.5
    b = torch.randn(groups, c, device=DEV)
    got = bn_k.bn_act(x, a, b, relu=relu)
    want = bn_ref.bn_act(x, a, b, relu=relu)
    torch.cuda.synchronize()
    tol = f"1 ulp of {dtype}"
    err, ok = compare(got, want, ulp(dtype), torch.finfo(dtype).tiny)
    nbytes = 2 * x.numel() * x.element_size() + 2 * a.numel() * 4
    record("bn_act", x.shape, dtype, err, ok, tol,
           lambda: bn_k.bn_act(x, a, b, relu=relu),
           lambda: bn_ref.bn_act(x, a, b, relu=relu), nbytes, 3 * x.numel())


def check_xent(rows, v, dtype):
    x = (3 * torch.randn(rows, v, device=DEV)).to(dtype)
    lab = torch.randint(0, v, (rows,), device=DEV)
    nll, lse = xent_k.xent_fwd(x, lab)
    nll_p, lse_p = xent_ref.xent_fwd(x, lab)
    torch.cuda.synchronize()
    e1, ok1 = compare(nll, nll_p, 1e-5, 1e-5)
    e2, ok2 = compare(lse, lse_p, 1e-5, 1e-5)
    nbytes = x.numel() * x.element_size() + rows * 8 + 2 * rows * 4
    record("xent_fwd", x.shape, dtype, max(e1, e2), ok1 and ok2,
           "1e-5 relative (f32 math)",
           lambda: xent_k.xent_fwd(x, lab),
           lambda: xent_ref.xent_fwd(x, lab), nbytes, 5 * x.numel(),
           library=lambda: torch.nn.functional.cross_entropy(
               x, lab, reduction="none"))

    g = torch.rand(rows, device=DEV) / rows
    dx = xent_k.xent_bwd(x, lab, lse_p, g)
    dx_p = xent_ref.xent_bwd(x, lab, lse_p, g)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        tol, rel = "1e-5 relative", 1e-5
    else:
        tol, rel = f"1 ulp of {dtype}", ulp(dtype)
    err, ok = compare(dx, dx_p, rel, 1e-6 * float(g.max()))
    nbytes = 2 * x.numel() * x.element_size() + rows * (8 + 4 + 4)
    record("xent_bwd", x.shape, dtype, err, ok, tol,
           lambda: xent_k.xent_bwd(x, lab, lse_p, g),
           lambda: xent_ref.xent_bwd(x, lab, lse_p, g), nbytes,
           5 * x.numel())


# Main-path shapes at full width: ResNet-56 (width 16, 100 classes), 100
# clients x batch 8, 32x32 images; the pool is 800 rows of 32*32*16.
POOL, HW, WIDTH, CLASSES, CLIENTS, BATCH = 800, 32, 16, 100, 100, 8


def kernels_vs_plain():
    phase("2. kernels against their plain versions (full width + ragged)")
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        check_permute(POOL, (HW, HW, WIDTH), dtype)
        if dtype == torch.bfloat16:
            main["collector_permute"] = RESULTS[-1]
        check_permute(37, (5, 7, 3), dtype)
        # server BN at each stage (G = 1), then the client BN of all
        # clients in one launch (G = 100, each with its own affine)
        for s, c in enumerate((WIDTH, 2 * WIDTH, 4 * WIDTH)):
            check_bn_act(1, POOL * (HW >> s) ** 2, c, dtype)
            if dtype == torch.bfloat16 and s == 0:
                main["bn_act"] = RESULTS[-1]
        check_bn_act(CLIENTS, BATCH * HW * HW, WIDTH, dtype)
        check_bn_act(3, 1001, 5, dtype, relu=False)
        check_xent(POOL, CLASSES, dtype)
        if dtype == torch.bfloat16:
            main["xent_fwd"], main["xent_bwd"] = RESULTS[-2], RESULTS[-1]
        check_xent(37, 13, dtype)
    return main


# --------------------------------------------------------------------------
# phases 3-5: the port's main path

def build_run(depth, clients, hw, seed=0, device=DEV):
    """Split ResNet (width 16, one class per client) on the mixed-precision
    path, synthetic CIFAR (4 local batches of 8 per client) and the
    initial SFPL state, all drawn from ``seed`` on the CPU and moved to
    ``device``."""
    from repro_torch.core import engine as E
    from repro_torch.data import (make_synthetic_cifar,
                                  partition_positive_labels)
    from repro_torch.models import resnet as R
    from repro_torch.models.common import ComputePolicy
    from repro_torch.optim import sgd_momentum
    from repro_torch.tree import to_device
    cfg = R.ResNetConfig(depth=depth, num_classes=clients, width=WIDTH)
    gen = torch.Generator().manual_seed(seed)
    tx, ty, _, _ = make_synthetic_cifar(gen, num_classes=clients,
                                        train_per_class=4 * BATCH,
                                        test_per_class=1, hw=hw,
                                        device=device)
    data = partition_positive_labels(tx, ty, clients)
    split = E.make_resnet_split(cfg, policy=ComputePolicy("bfloat16"))
    opt = sgd_momentum(0.05, momentum=0.9, weight_decay=5e-4)
    st = to_device(E.init_dcml_state(gen, lambda g: R.init(g, cfg), clients,
                                     opt, opt), device)
    return cfg, data, split, opt, st


def sfpl_epoch_on(run, clients, gen_seed, device=DEV, steps=None):
    from repro_torch.core import round as RD
    _, data, split, opt, st = run
    if steps is not None:
        data = {k: v[:, :steps * BATCH] for k, v in data.items()}
    return RD.sfpl_round(torch.Generator().manual_seed(gen_seed), st, data,
                         split, opt, opt, num_clients=clients,
                         batch_size=BATCH,
                         collector=RD.DenseTake(clients, use_kernel=True),
                         device=device)


def main_path():
    phase("3. main path: sfpl_round, ResNet-56 width 16, 100 clients x "
          "batch 8, 32x32, bf16, DenseTake(use_kernel=True), 4 steps")
    run = build_run(56, CLIENTS, HW)
    steps = 4
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    _, losses = sfpl_epoch_on(run, CLIENTS, gen_seed=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    losses = losses.float().cpu()
    print(f"losses {losses.tolist()}")
    print(f"epoch wall {wall:.3f} s ({wall / steps * 1e3:.1f} ms/step, "
          f"first epoch: cuDNN autotuning and allocator warm-up included), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print("launches per step: " + ", ".join(
        f"{k} {v / steps:g}" for k, v in launches.items()))
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite losses {losses.tolist()}")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")

    # a second run, warm, timed and traced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sfpl_epoch_on(run, CLIENTS, gen_seed=2)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    print(f"warm epoch wall {warm:.3f} s ({warm / steps * 1e3:.1f} ms/step)")
    profile_steps(run)
    return launches


def profile_steps(run, steps=2):
    """Device time by kernel over ``steps`` warm SFPL steps
    (torch.profiler), and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sfpl_epoch_on(run, CLIENTS, gen_seed=3, steps=steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel rows only: an operator row repeats the device time of the
    # kernels it launched
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    print(f"profile over {steps} warm steps: wall {wall_us / 1e3:.1f} ms, "
          f"device busy {busy / 1e3:.1f} ms "
          f"({100 * busy / wall_us:.1f}% of wall)")
    ours = {"collector_permute": "permute_rows", "bn_act": "bn_act_kernel",
            "xent_fwd": "xent_fwd_kernel", "xent_bwd": "xent_bwd_kernel"}
    for name, sym in ours.items():
        us = sum(r[1] for r in rows if sym in r[0])
        n = sum(r[2] for r in rows if sym in r[0])
        print(f"  {name}: {us / 1e3:.3f} ms over {n} launches "
              f"({100 * us / max(busy, 1):.2f}% of device time)")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:15]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / max(busy, 1):5.1f}% "
              f"x{count:<5d} {key[:90]}")


def entry_point():
    phase("4. entry point: launch.train.train_paper, ResNet-56, 100 "
          "clients, bf16, 1 epoch")
    from repro_torch.launch.train import train_paper
    K.reset_launches()
    losses = train_paper(depth=56, width=WIDTH, hw=HW, num_clients=CLIENTS,
                         batch_size=BATCH, epochs=1,
                         compute_dtype="bfloat16")
    torch.cuda.synchronize()
    print(f"train_paper mean losses {losses}; launches {dict(K.LAUNCHES)}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss {losses}")
    missing = [k for k, v in K.LAUNCHES.items() if v <= 0]
    if missing:
        raise AssertionError(f"train_paper launched no {missing}")


def card_vs_cpu():
    phase("5. the path on the card (kernels) against the CPU (plain "
          "versions): ResNet-8 width 16, 10 clients x batch 8, 32x32, "
          "bf16, 2 steps, same init and permutations")
    clients, steps = 10, 2
    cpu = torch.device("cpu")
    _, l_gpu = sfpl_epoch_on(build_run(8, clients, HW), clients, gen_seed=4,
                             steps=steps)
    _, l_cpu = sfpl_epoch_on(build_run(8, clients, HW, device=cpu), clients,
                             gen_seed=4, device=cpu, steps=steps)
    l_gpu, l_cpu = l_gpu.float().cpu(), l_cpu.float()
    d = float((l_gpu - l_cpu).abs().max())
    print(f"losses card {l_gpu.tolist()} cpu {l_cpu.tolist()} "
          f"max |diff| {d:.3e} (tol 1e-2)")
    if not d <= 1e-2:
        raise AssertionError(f"card and CPU losses differ by {d}")


def main():
    smi = device_and_build()
    measured = kernels_vs_plain()
    launches = main_path()
    entry_point()
    card_vs_cpu()
    lines = []
    for name, row in measured.items():
        route, source = ROUTE[name]
        lines.append(dict(
            name=name, route=route, source=source, replaces=REPLACES[name],
            launches=launches[name], max_abs_err=row["max_abs_err"],
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            shape=row["shape"], dtype=row["dtype"], tol=row["tol"]))
    print(smi)
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
