"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to account.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100:
the kernels are built for sm_90a). It builds the hand-written kernels from
``src/repro_torch/kernels``, checks each against its plain PyTorch version
at the main paths' shapes, drives the SFPL trainer at full ResNet-56 width
on one device (phases 3-5) and the sharded SFPL epoch on a world-size-1
NCCL group with the int8 wire (phase 6), and prints, as its last line,
``{"ok": true, "device": {...}}``. Any failed phase raises and the script
exits non-zero without that line. Without CUDA, or outside a checkout, it
exits non-zero at once.
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
from repro_torch.kernels.quant_permute import kernel as quant_k  # noqa
from repro_torch.kernels.quant_permute import ref as quant_ref   # noqa
from repro_torch.kernels.softmax_xent import kernel as xent_k  # noqa: E402
from repro_torch.kernels.softmax_xent import ref as xent_ref   # noqa: E402

DEV = torch.device("cuda")
REPLACES = {
    "collector_permute": "src/repro/kernels/collector_permute/kernel.py:33",
    "bn_act": "src/repro/kernels/bn_act/kernel.py:30",
    "xent_fwd": "src/repro/kernels/softmax_xent/kernel.py:50",
    "xent_bwd": "src/repro/kernels/softmax_xent/kernel.py:79",
    "bucket_permute": "src/repro/kernels/collector_permute/kernel.py:57",
    "unbucket_permute": "src/repro/kernels/collector_permute/kernel.py:92",
    "quant_bucket_permute": "src/repro/kernels/quant_permute/kernel.py:47",
    "dequant_unbucket_permute":
        "src/repro/kernels/quant_permute/kernel.py:89",
}
ROUTE = {"collector_permute": ("cuda", perm_k.SOURCE),
         "bn_act": ("cuda", bn_k.SOURCE),
         "xent_fwd": ("triton", xent_k.SOURCE),
         "xent_bwd": ("triton", xent_k.SOURCE),
         "bucket_permute": ("cuda", perm_k.SOURCE),
         "unbucket_permute": ("cuda", perm_k.SOURCE),
         "quant_bucket_permute": ("cuda", quant_k.SOURCE),
         "dequant_unbucket_permute": ("cuda", quant_k.SOURCE)}
# the kernels of the single-device path (phases 3-5); the sharded path
# (phase 6) adds the other four
SINGLE_DEVICE = ("collector_permute", "bn_act", "xent_fwd", "xent_bwd")
# kernel symbols in a profile, per launch counter
SYMBOL = {"collector_permute": "permute_rows", "bn_act": "bn_act_kernel",
          "xent_fwd": "xent_fwd_kernel", "xent_bwd": "xent_bwd_kernel",
          "bucket_permute": "bucket_gather_rows",
          "unbucket_permute": "recv_gather_rows",
          "quant_bucket_permute": "quant_bucket_rows",
          "dequant_unbucket_permute": "dequant_recv_rows"}


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


def check_bucket(rows, feat, dtype, sc, pad):
    """K4a at (S, cap) = ``sc`` from ``rows`` rows, then K4b back from the
    flat block (plus the zero pad row when ``pad``) into ``rows`` rows,
    each against its plain gather, bitwise. Indices are int32, the route
    plan's dtype."""
    x = torch.randn((rows,) + feat, device=DEV).to(dtype)
    k = sc[0] * sc[1]
    idx = (torch.randperm(rows, device=DEV)[:k] if k <= rows else
           torch.randint(0, rows, (k,), device=DEV)).to(torch.int32)
    idx = idx.reshape(sc)
    got = perm_k.bucket_permute(x, idx)
    want = perm_ref.bucket_permute(x, idx)
    torch.cuda.synchronize()
    row_bytes = x[0].numel() * x.element_size()
    record("bucket_permute", (k,) + feat, dtype, 0.0 if torch.equal(
               got, want) else float((got.float() - want.float()).abs()
                                     .max()), torch.equal(got, want),
           "bitwise", lambda: perm_k.bucket_permute(x, idx),
           lambda: perm_ref.bucket_permute(x, idx), 2 * k * row_bytes
           + k * 4, 0,
           library=lambda: torch.index_select(x, 0, idx.reshape(-1)))
    flat = torch.cat([got, torch.zeros_like(got[:pad])])
    ridx = torch.randperm(flat.shape[0], device=DEV)[:rows].to(torch.int32)
    got = perm_k.unbucket_permute(flat, ridx)
    want = perm_ref.unbucket_permute(flat, ridx)
    torch.cuda.synchronize()
    record("unbucket_permute", (rows,) + feat, dtype, 0.0 if torch.equal(
               got, want) else float((got.float() - want.float()).abs()
                                     .max()), torch.equal(got, want),
           "bitwise", lambda: perm_k.unbucket_permute(flat, ridx),
           lambda: perm_ref.unbucket_permute(flat, ridx),
           2 * rows * row_bytes + rows * 4, 0,
           library=lambda: torch.index_select(flat, 0, ridx))


def _wire_err(got, want):
    return float((got.float() - want.float()).abs().max())


def check_quant(rows, d, dtype, wire, sc, pad):
    """K5a writing the packed wire payload (S*cap, d + 4) from ``rows``
    rows, then K5b reading that payload (q view and scale lanes in place,
    plus the zero pad row when ``pad``) into ``rows`` rows: quantized
    bytes, scales and dequantized values bitwise against the plain
    versions. An all-zero row is included."""
    from repro_torch.core.wire import pack_scales, unpack_scales
    x = (3 * torch.randn(rows, d, device=DEV)).to(dtype)
    x[1] = 0
    k = sc[0] * sc[1]
    idx = (torch.randperm(rows, device=DEV)[:k] if k <= rows else
           torch.randint(0, rows, (k,), device=DEV)).to(torch.int32)
    idx = idx.reshape(sc)
    payload = quant_k.quant_bucket_permute(x, idx, wire, packed=True)

    def plain_send():
        q, s = quant_ref.quant_bucket_permute(x, idx, wire)
        return torch.cat([q, pack_scales(s, wire)], dim=1)
    want = plain_send()
    torch.cuda.synchronize()
    ok = torch.equal(payload.view(torch.uint8), want.view(torch.uint8))
    err = max(_wire_err(payload[:, :d], want[:, :d]), _wire_err(
        unpack_scales(payload[:, d:]), unpack_scales(want[:, d:])))
    isz = x.element_size()
    record("quant_bucket_permute", (k, d), f"{dtype}->{wire}", err, ok,
           "bitwise (q bytes and f32 scales)",
           lambda: quant_k.quant_bucket_permute(x, idx, wire, packed=True),
           plain_send, k * d * isz + k * 4 + k * (d + 4), 4 * k * d)
    flat = torch.cat([payload, torch.zeros_like(payload[:pad])])
    ridx = torch.randperm(flat.shape[0], device=DEV)[:rows].to(torch.int32)
    q, lanes = flat[:, :d], flat[:, d:]
    got = quant_k.dequant_unbucket_permute(q, lanes, ridx, dtype)

    def plain_recv():
        return quant_ref.dequant_unbucket_permute(q, unpack_scales(lanes),
                                                  ridx, dtype)
    want = plain_recv()
    torch.cuda.synchronize()
    record("dequant_unbucket_permute", (rows, d), f"{wire}->{dtype}",
           _wire_err(got, want), torch.equal(got, want), "bitwise",
           lambda: quant_k.dequant_unbucket_permute(q, lanes, ridx, dtype),
           plain_recv, rows * (d + 4) + rows * 4 + rows * d * isz, rows * d)


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
        # the sharded path at world size 1: one bucket of the 800-row pool
        check_bucket(POOL, (HW, HW, WIDTH), dtype, (1, POOL), pad=0)
        if dtype == torch.bfloat16:
            main["bucket_permute"], main["unbucket_permute"] = \
                RESULTS[-2], RESULTS[-1]
        check_bucket(37, (5, 7, 3), dtype, (4, 10), pad=1)
        for wire in ("int8", "float8_e4m3"):
            check_quant(POOL, HW * HW * WIDTH, dtype, wire, (1, POOL), 0)
            if dtype == torch.bfloat16 and wire == "int8":
                main["quant_bucket_permute"] = RESULTS[-2]
                main["dequant_unbucket_permute"] = RESULTS[-1]
            check_quant(37, 105, dtype, wire, (4, 10), 1)
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
    missing = [k for k in SINGLE_DEVICE if launches[k] <= 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")

    # a second run, warm, timed and traced
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sfpl_epoch_on(run, CLIENTS, gen_seed=2)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    print(f"warm epoch wall {warm:.3f} s ({warm / steps * 1e3:.1f} ms/step)")
    profile_steps(lambda k: sfpl_epoch_on(run, CLIENTS, gen_seed=3, steps=k))
    return launches


def profile_steps(epoch, steps=2):
    """Device time by kernel over ``steps`` warm SFPL steps
    (``epoch(steps)`` under torch.profiler), and the device's busy share
    of the wall time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        epoch(steps)
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
    waits = {e.key: (e.count, e.cpu_time_total) for e in prof.key_averages()
             if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaMemcpyAsync", "aten::_local_scalar_dense",
                          "cudaStreamWaitEvent", "ncclDevKernel_SendRecv",
                          "nccl:all_to_all", "nccl:all_reduce")}
    print("  host waits and collectives: " + ", ".join(
        f"{k} x{c} ({t / 1e3:.2f} ms)" for k, (c, t) in sorted(
            waits.items())))
    for name, sym in SYMBOL.items():
        us = sum(r[1] for r in rows if sym in r[0])
        n = sum(r[2] for r in rows if sym in r[0])
        if n:
            print(f"  {name}: {us / 1e3:.3f} ms over {n} launches "
                  f"({100 * us / max(busy, 1):.2f}% of device time)")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:15]:
        print(f"  {us / 1e3:9.3f} ms {100 * us / max(busy, 1):5.1f}% "
              f"x{count:<5d} {key[:90]}")
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()), key=lambda r: -r[1])[:12]
    print("  host (self CPU time): " + "; ".join(
        f"{k[:40]} {us / 1e3:.2f} ms x{c}" for k, us, c in host))


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
    missing = [k for k in SINGLE_DEVICE if K.LAUNCHES[k] <= 0]
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


def given_perms(clients, perms):
    """Phase 3's collector (``DenseTake`` through K1) drawing the given
    permutations in order."""
    import dataclasses
    from repro_torch.core import round as RD

    @dataclasses.dataclass(frozen=True)
    class GivenPerms(RD.DenseTake):
        it: object = None

        def make_perm(self, gen, n, device=None):
            return next(self.it)
    return GivenPerms(clients, use_kernel=True, it=iter(perms))


def sharded_epoch(run, group, gen_seed, wire, steps=None, use_kernel=None):
    """``sfpl_epoch_sharded`` over ``group`` (balanced mode, exact
    backward); ``use_kernel=False`` swaps the K4/K5 kernels for their
    plain versions."""
    from repro_torch.core import engine_dist as ED
    _, data, split, opt, st = run
    if steps is not None:
        data = {k: v[:, :steps * BATCH] for k, v in data.items()}
    data = ED.shard_client_data(data, group)
    st = ED.shard_dcml_state(st, group)
    return ED.sfpl_epoch_sharded(
        torch.Generator().manual_seed(gen_seed), st, data, split, opt, opt,
        group=group, num_clients=CLIENTS, batch_size=BATCH,
        collector_mode="balanced", wire_dtype=wire, use_kernel=use_kernel,
        device=DEV)


def timed_epoch(epoch):
    """Host wall seconds of one epoch, synchronised before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    epoch()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def sharded_path():
    phase("6. sharded path: sfpl_epoch_sharded on a world-size-1 NCCL group,"
          " ResNet-56 width 16, 100 clients x batch 8, 32x32, bf16, int8 "
          "wire, exact backward, balanced, 4 steps")
    from repro_torch.core import engine_dist as ED
    from repro_torch.core import round as RD
    from repro_torch.core.collector_dist import plan_payload_bytes
    run = build_run(56, CLIENTS, HW)
    steps = 4
    sfpl_epoch_on(run, CLIENTS, gen_seed=2)
    dense_down = timed_epoch(lambda: sfpl_epoch_on(run, CLIENTS, gen_seed=2))
    group = ED.init_data_group(DEV)
    try:
        import torch.distributed as dist
        print(f"process group: {group}, backend {dist.get_backend()}")
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        _, l_int8 = sharded_epoch(run, group, 1, "int8")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        print(f"losses (int8 wire) {l_int8.float().cpu().tolist()}")
        print(f"first epoch wall {wall:.3f} s")
        print("launches per step: " + ", ".join(
            f"{k} {v / steps:g}" for k, v in launches.items()))
        ours = ("bucket_permute", "unbucket_permute", "quant_bucket_permute",
                "dequant_unbucket_permute")
        missing = [k for k in ours if launches[k] <= 0]
        if missing:
            raise AssertionError(f"sharded path launched no {missing}")
        if not bool(torch.isfinite(l_int8).all()):
            raise AssertionError(f"non-finite losses {l_int8.tolist()}")

        # warm epochs in turns, all in this process: phase 3's dense path
        # before the NCCL group exists (above) and with it up, and the
        # sharded path; what the group alone costs the host shows apart
        # from what the exchange adds
        turns = {"dense, group up": [], "sharded int8": []}
        for _ in range(2):
            turns["dense, group up"].append(timed_epoch(
                lambda: sfpl_epoch_on(run, CLIENTS, gen_seed=2)))
            turns["sharded int8"].append(timed_epoch(
                lambda: sharded_epoch(run, group, 2, "int8")))
        print(f"warm epoch wall in turns (ms/step): dense, group down "
              f"{dense_down / steps * 1e3:.1f}; " + "; ".join(
                  f"{k} " + ", ".join(f"{t / steps * 1e3:.1f}" for t in v)
                  for k, v in turns.items()))
        warm = min(turns["sharded int8"])
        print(f"warm epoch wall {warm:.3f} s ({warm / steps * 1e3:.1f} "
              f"ms/step, int8 wire, the faster of two)")

        coll = group.collector(CLIENTS, wire_dtype="int8")
        n = CLIENTS * BATCH
        prep = coll.prepare(coll.make_perm(torch.Generator().manual_seed(1),
                                           n, DEV), n)
        row = HW * HW * WIDTH
        fwd_b = coll.exchange_bytes(prep, row, torch.bfloat16)
        bwd_b = plan_payload_bytes(prep.plans[1], row, 2)
        print(f"exchange bytes per step: forward {fwd_b} (int8 rows + f32 "
              f"scale lanes), backward {bwd_b} (exact bf16), bf16 forward "
              f"would be {plan_payload_bytes(prep.plans[0], row, 2)}")

        # the exact wire against the dense single-device path, same init
        # and permutations; the int8 wire through the kernels against the
        # same through the plain versions; the int8 wire against the exact
        # one. cuDNN deterministic for these runs only: its atomics would
        # put run-to-run noise between otherwise bit-equal paths.
        gen = torch.Generator().manual_seed(1)
        perms = [coll.make_perm(gen, n, DEV) for _ in range(steps)]
        _, data, split, opt, st = run
        torch.backends.cudnn.deterministic = True
        _, l_dense = RD.sfpl_round(None, st, data, split, opt, opt,
                                   num_clients=CLIENTS, batch_size=BATCH,
                                   collector=given_perms(CLIENTS, perms),
                                   device=DEV)
        _, l_exact = sharded_epoch(run, group, 1, None)
        _, l_int8 = sharded_epoch(run, group, 1, "int8")
        _, l_int8_plain = sharded_epoch(run, group, 1, "int8",
                                        use_kernel=False)
        torch.backends.cudnn.deterministic = False
        l_dense, l_exact, l_int8, l_int8_plain = (
            t.float().cpu() for t in (l_dense, l_exact, l_int8,
                                      l_int8_plain))
        d_exact = float((l_exact - l_dense).abs().max())
        d_plain = float((l_int8 - l_int8_plain).abs().max())
        gap = (l_int8 - l_exact).abs()
        print(f"losses dense (K1) {l_dense.tolist()}\n"
              f"  sharded exact (K4) {l_exact.tolist()}: max |diff| "
              f"{d_exact:.3e} (tol 1e-5)\n"
              f"  sharded int8 (K5 + K4) {l_int8.tolist()}, the same with "
              f"the plain versions {l_int8_plain.tolist()}: max |diff| "
              f"{d_plain:.3e} (tol 1e-5)\n"
              f"  int8 against exact, by step: "
              f"{[f'{v:.3e}' for v in gap.tolist()]} (tol 1.5e-2 over the "
              f"first 2 steps, the horizon of the reference's bound)")
        if not d_exact <= 1e-5:
            raise AssertionError(f"sharded exact path differs from the "
                                 f"dense one by {d_exact}")
        if not d_plain <= 1e-5:
            raise AssertionError(f"int8 path through the kernels differs "
                                 f"from the plain one by {d_plain}")
        if not float(gap[:2].max()) <= 1.5e-2:
            raise AssertionError(f"int8 wire differs by {gap.tolist()}")
        profile_steps(lambda k: sharded_epoch(run, group, 3, "int8",
                                              steps=k))
        exchange_breakdown(group)
    finally:
        ED.close_data_group()
    return launches


def host_ms(fn, reps=10):
    """Wall time per call of ``fn`` on the host clock, synchronised before
    and after (warm: one call first)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def exchange_breakdown(group):
    """Wall time of each piece the sharded step adds to the dense one, at
    the main path's shapes (800-row pool of 32x32x16 bf16 rows, int8
    wire): drawing the permutation and building both route plans, the
    label exchange, and the activation exchange forward and backward,
    beside the dense path's K1 shuffle forward and backward."""
    from repro_torch.core import round as RD
    coll = group.collector(CLIENTS, wire_dtype="int8")
    n = CLIENTS * BATCH
    gen = torch.Generator().manual_seed(5)
    a = torch.randn(n, HW, HW, WIDTH, device=DEV).to(torch.bfloat16)
    a.requires_grad_()
    y = torch.randint(0, CLIENTS, (n,), device=DEV)
    prep = coll.prepare(coll.make_perm(gen, n, DEV), n)
    dense = RD.DenseTake(CLIENTS, use_kernel=True)
    dprep = dense.prepare(prep.perm, n)

    def fwd_bwd(c, p):
        return torch.autograd.grad(c.permute(a, p).float().sum(), a)
    parts = {
        "perm + both route plans": lambda: coll.prepare(
            coll.make_perm(gen, n, DEV), n),
        "label exchange (int64, plain gather)": lambda: coll.permute(y,
                                                                     prep),
        "activation exchange fwd (K5a, all_to_all, K5b)": lambda:
            coll.permute(a.detach(), prep),
        "activation exchange fwd + bwd (+ K4a, all_to_all, K4b)": lambda:
            fwd_bwd(coll, prep),
        "dense shuffle fwd + bwd (K1 twice)": lambda: fwd_bwd(dense, dprep),
    }
    print("exchange pieces, host wall per call (synchronised): " + "; ".join(
        f"{k} {host_ms(f):.3f} ms" for k, f in parts.items()))


def sharded_entry_point():
    phase("7. entry point: python -m repro_torch.launch.train --paper "
          "--sharded --wire-dtype float8_e4m3 (world size 1, NCCL)")
    env = dict(os.environ, PYTHONPATH=str(HERE / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--paper",
         "--sharded", "--wire-dtype", "float8_e4m3", "--epochs", "2"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
    print(res.stdout.strip())
    if res.returncode != 0:
        raise AssertionError(f"sharded train exited {res.returncode}:\n"
                             f"{res.stderr[-4000:]}")
    if "sharded SFPL: 1 rank(s)" not in res.stdout:
        raise AssertionError("sharded train did not run the sharded path")


def main():
    smi = device_and_build()
    measured = kernels_vs_plain()
    launches = main_path()
    entry_point()
    card_vs_cpu()
    launches_sharded = sharded_path()
    sharded_entry_point()
    for name in ("bucket_permute", "unbucket_permute", "quant_bucket_permute",
                 "dequant_unbucket_permute"):
        launches[name] = launches_sharded[name]
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
