"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to account.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100:
the kernels are built for sm_90a). It builds the hand-written kernels from
``src/repro_torch/kernels``, checks each against its plain PyTorch version
at the main paths' shapes, drives the SFPL trainer at full ResNet-56 width
on one device (phases 3-5) and the sharded SFPL epoch on a world-size-1
NCCL group with the int8 wire (phases 6-7), then qwen3-8b at full width:
the prefill through the flash-attention kernel (phase 8), 2-layer f32
checks of prefill, cached decode and the continuous-batching scheduler
(phase 9), and serving (phase 10); then xlstm-1.3b at full width: the
prefill through the sLSTM-scan kernel (phase 11), 1-group f32 checks of
prefill and cached decode (phase 12), and serving (phase 13); then
gemma-7b at full width: the prefill through the flash-attention kernel at
head_dim 256 (phase 14), 2-layer f32 checks as phase 9's and a 2-layer
bf16 prefill against the plain attention path, with minitron-8b's and
phi3-medium-14b's at D 128 (phase 15), and serving (phase 16); then the
paper's comparison: ``launch.eval.evaluate_paper`` at ResNet-56 width, 100
clients, bf16, 2 epochs, with K1-K3 counted and seen by the profiler
(phase 17), the double-buffered collector on a world-size-1 NCCL group,
sub-mesh at alpha 1.0 and the whole-mesh fallback at 0.5, at the exact
and the int8 wire, each equal to the sync exchange's losses and through
K4a/K4b or K5a/K5b (phase 18), and the entry points ``launch.eval --paper
--sharded --pipeline double_buffered`` and ``launch.train --paper
--sharded --scheme sflv2`` (phase 19); then fault-tolerant SFPL:
``train_paper`` at the same width with dropouts and stragglers, 3 epochs
against 2 and a resume from the checkpoint, whose losses must be equal
exactly, K1-K3 counted each epoch, and one sharded masked epoch through
K4a/K4b (phase 20); LM training at full width, f32, AdamW on a fixed
batch: qwen3-8b at 2 layers with the chunked loss against the full
logits' and the SFPL loss checks, and xlstm-1.3b at 1 group, each loss
falling (phase 21); and the entry points ``launch.train --paper`` with
faults, ``--ckpt`` and ``--resume``, ``launch.train --arch qwen3-8b
--ckpt`` and ``launch.eval --arch qwen3-8b --ckpt``, which must beat the
untrained init (phase 22). Each phase prints its seconds. It
prints, as its last line, ``{"ok": true, "device": {...}}``. Any failed
phase raises and the script
exits non-zero without that line. Without CUDA, or outside a checkout, it
exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import os
import re
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
import numpy as np                                            # noqa: E402

from repro_torch import kernels as K                          # noqa: E402
from repro_torch.configs import get_arch                      # noqa: E402
from repro_torch.kernels import build                         # noqa: E402
from repro_torch.kernels.bn_act import kernel as bn_k         # noqa: E402
from repro_torch.kernels.bn_act import ref as bn_ref          # noqa: E402
from repro_torch.kernels.collector_permute import kernel as perm_k  # noqa
from repro_torch.kernels.collector_permute import ref as perm_ref   # noqa
from repro_torch.kernels.flash_attention import kernel as flash_k  # noqa
from repro_torch.kernels.flash_attention import ref as flash_ref   # noqa
from repro_torch.kernels.quant_permute import kernel as quant_k  # noqa
from repro_torch.kernels.quant_permute import ref as quant_ref   # noqa
from repro_torch.kernels.rmsnorm import kernel as rms_k      # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rms_ref        # noqa: E402
from repro_torch.kernels.slstm_scan import kernel as slstm_k  # noqa: E402
from repro_torch.kernels.slstm_scan import ref as slstm_ref   # noqa: E402
from repro_torch.kernels.softmax_xent import kernel as xent_k  # noqa: E402
from repro_torch.kernels.softmax_xent import ref as xent_ref   # noqa: E402
from repro_torch.kernels.softmax_xent import probe as xent_probe  # noqa
from repro_torch.tree import tree_leaves                      # noqa: E402

DEV = torch.device("cuda")
# copies of a gather's input timed in turn so that reads come from device
# memory: 4 x 26 MB of the pool is over twice the 50 MB L2
ROTATE = 4
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
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:30",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:85",
    "slstm_scan": "src/repro/kernels/slstm_scan/kernel.py:73",
}
# K7 at head_dim 256 (gemma-7b) has a row of its own in the kernels line
REPLACES["flash_attention_d256"] = REPLACES["flash_attention"]
ROUTE = {"collector_permute": ("cuda", perm_k.SOURCE),
         "bn_act": ("cuda", bn_k.SOURCE),
         "xent_fwd": ("triton", xent_k.SOURCE),
         "xent_bwd": ("triton", xent_k.SOURCE),
         "bucket_permute": ("cuda", perm_k.SOURCE),
         "unbucket_permute": ("cuda", perm_k.SOURCE),
         "quant_bucket_permute": ("cuda", quant_k.SOURCE),
         "dequant_unbucket_permute": ("cuda", quant_k.SOURCE),
         "rmsnorm": ("triton", rms_k.SOURCE),
         "flash_attention": ("cuda", flash_k.SOURCE),
         "slstm_scan": ("cuda", slstm_k.SOURCE)}
ROUTE["flash_attention_d256"] = ROUTE["flash_attention"]
# the kernels of the single-device path (phases 3-5); the sharded path
# (phase 6) adds the other four
SINGLE_DEVICE = ("collector_permute", "bn_act", "xent_fwd", "xent_bwd")
# kernel symbols in a profile, per launch counter
SYMBOL = {"collector_permute": "permute_rows", "bn_act": "bn_act_kernel",
          "xent_fwd": "xent_fwd_kernel", "xent_bwd": "xent_bwd_kernel",
          "bucket_permute": "bucket_gather_rows",
          "unbucket_permute": "recv_gather_rows",
          "quant_bucket_permute": "quant_bucket_rows",
          "dequant_unbucket_permute": "dequant_recv_rows",
          "rmsnorm": "rmsnorm_kernel", "flash_attention": "flash_fwd",
          "slstm_scan": "slstm_scan_sliced"}
_CLOCK = {"start": time.perf_counter(), "last": None}


def phase(name):
    """Start a phase: print the seconds the previous one took."""
    now = time.perf_counter()
    if _CLOCK["last"] is not None:
        print(f"(phase took {now - _CLOCK['last']:.1f} s)")
    _CLOCK["last"] = now
    print(f"\n=== {name} [t = {now - _CLOCK['start']:.1f} s]", flush=True)


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
        entry = entry_name(line)
        if entry:
            print(f"  entry {entry}")
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())
    kernel_resources()
    return smi


def entry_name(line):
    """``name<D>`` of a template kernel that ptxas reports compiling: the
    length-prefixed identifier before ``ILi<D>E`` in its mangled name."""
    m = re.search(r"entry function '(\S+?)'", line)
    i = m.group(1).find("ILi") if m else -1
    if i < 0:
        return None
    sym = m.group(1)
    for j in range(i):
        n = re.match(r"\d+", sym[j:])
        if n and j + len(n.group()) + int(n.group()) == i:
            arg = re.match(r"ILi(\d+)E", sym[i:]).group(1)
            return f"{sym[j + len(n.group()):i]}<{arg}>"
    return None


def triton_resources(jit, grid, *args, **meta):
    """Registers, shared memory and CTAs an SM of one Triton kernel, from
    its compiled binary and the driver's occupancy query (the launch that
    compiles it counts nowhere)."""
    import ctypes
    ck = jit[grid](*args, **meta)
    torch.cuda.synchronize()
    smem = int(ck.metadata.shared)
    ctas = ctypes.c_int(0)
    cuda = ctypes.CDLL("libcuda.so.1")
    err = cuda.cuOccupancyMaxActiveBlocksPerMultiprocessor(
        ctypes.byref(ctas), ctypes.c_void_p(ck.function),
        ctypes.c_int(32 * meta["num_warps"]), ctypes.c_size_t(smem))
    if err != 0:
        raise RuntimeError(f"cuOccupancyMaxActiveBlocksPerMultiprocessor: "
                           f"CUresult {err}")
    return dict(registers=ck.n_regs, spills=ck.n_spills, smem=smem,
                warps=meta["num_warps"], ctas_per_sm=ctas.value)


def kernel_resources():
    """K7's kernels (the runtime's attributes and occupancy) and K3f/K3b's
    at the main path's 800 x 100 bf16 (their compiled binaries)."""
    for d in (256, 128, 64, 32):
        res = flash_k.resources(d)
        print(f"  K7 bf16 D {d}: {json.dumps(res)}")
        if d in flash_k.TMA_HEAD_DIMS and (res["kernel"] != "hopper"
                                           or res["local_bytes"] != 0):
            raise AssertionError(f"K7 bf16 D {d}: not the spill-free "
                                 f"Hopper kernel: {res}")
    print(f"  K7 f32 D 256: "
          f"{json.dumps(flash_k.resources(256, torch.float32))}")
    fwd, bwd, _ = xent_k._kernels()
    x = torch.randn(POOL, CLASSES, device=DEV).to(torch.bfloat16)
    lab = torch.zeros(POOL, dtype=torch.int64, device=DEV)
    nll, lse = (torch.empty(POOL, device=DEV) for _ in range(2))
    geo = xent_k.geometry(CLASSES)
    programs = geo.programs(POOL)
    res = triton_resources(fwd, (programs,), x, lab, nll, lse, POOL,
                           CLASSES, x.stride(0), BLOCK_R=geo.rows,
                           BLOCK_V=geo.block_v, num_warps=geo.warps)
    print(f"  K3f {POOL} x {CLASSES} bf16, {programs} programs of "
          f"{geo.rows} rows: {json.dumps(res)}")
    res = triton_resources(bwd, (programs, geo.col_blocks), x, lab, lse, nll,
                           torch.empty_like(x), POOL, CLASSES, x.stride(0),
                           x.stride(0), BLOCK_R=geo.rows, BLOCK_V=geo.block_v,
                           num_warps=geo.warps)
    print(f"  K3b {POOL} x {CLASSES} bf16, {programs} programs of "
          f"{geo.rows} rows: {json.dumps(res)}")
    pl = slstm_k.card_plan(LM_BATCH, 4, 512)
    res = slstm_k.resources(pl.smem)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"  K8 at the prefill's B {LM_BATCH}, H 4, Dh 512: {json.dumps(dict(
        registers=res['registers'], threads=res['threads'],
        smem_dynamic=pl.smem, units=pl.units, rows=pl.rows,
        blocks_per_launch=[n * pl.slices for _, n in pl.launches],
        blocks_per_sm=res['blocks_per_sm'],
        co_resident=sms * res['blocks_per_sm']))}")


# --------------------------------------------------------------------------
# phase 2: every kernel against its plain version on the card

def time_ms(fn, iters=20, reps=5):
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph and replayed ``reps`` times between CUDA events, so host
    launch overhead is left out. Inputs stay the same from call to call
    (warm L2 where they fit in its 50 MB). ``fn`` may be a list of
    calls, taken in turn (each on its own copy of the inputs, to rotate
    them out of L2)."""
    fns = fn if isinstance(fn, (list, tuple)) else [fn]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            for f in fns:
                f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
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


def bound_ms(nbytes, flops, peak="float32"):
    """The larger of bytes over the HBM rate and operations over the peak
    rate of their type: ``float32`` (CUDA cores; elementwise work in any
    storage dtype is f32 math) or ``bfloat16`` (the tensor cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
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
           library=None, peak="float32", heavy=False, rotated=None):
    """Check, time and print one kernel row. ``heavy``: calls of many
    milliseconds whose plain version allocates gigabytes; timed with fewer
    calls, and the plain and library versions eagerly, not in a graph.
    ``rotated``: (kernel calls, library calls) on copies of the inputs
    that together exceed L2, timed as well (``rotated_ms``,
    ``library_rotated_ms``)."""
    if not ok:
        raise AssertionError(f"{name} {tuple(shape)} {dtype}: kernel "
                             f"disagrees with its plain version (max err "
                             f"{err}, tol {tol})")
    b, by = bound_ms(nbytes, flops, peak)
    if heavy:
        timed = lambda f: time_ms(f, iters=2, reps=2)   # noqa: E731
        other = lambda f: eager_ms(f, iters=2)          # noqa: E731
    else:
        timed = other = time_ms
    row = dict(name=name, shape=list(shape), dtype=str(dtype).split(".")[-1],
               max_abs_err=err, tol=tol, ok=ok, ms=timed(fn),
               eager_ms=eager_ms(fn, iters=2 if heavy else 20),
               plain_ms=other(plain), bound_ms=b, bound_by=by,
               library_ms=None if library is None else other(library))
    if rotated is not None:
        row["rotated_ms"], row["library_rotated_ms"] = map(time_ms, rotated)
    RESULTS.append(row)
    print(json.dumps(row), flush=True)


def rotations(x, rotate):
    """``x`` and ``rotate - 1`` copies of it, when ``rotate``."""
    return [x] + [x.clone() for _ in range(rotate - 1)] if rotate else [x]


def gather_rotated(kernel, xs, idx):
    """(kernel calls, index_select calls) over the copies ``xs``."""
    flat = idx.reshape(-1)
    return ([lambda x=x: kernel(x, idx) for x in xs],
            [lambda x=x: torch.index_select(x, 0, flat) for x in xs])


def check_permute(rows, feat, dtype, rotate=0):
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
           library=lambda: torch.index_select(x, 0, perm),
           rotated=gather_rotated(perm_k.collector_permute,
                                  rotations(x, rotate), perm)
           if rotate else None)


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


def check_gather_row(name, kernel, plain, x, idx, out_rows, rotate):
    """One K4 kernel against its plain gather, bitwise, timed warm and,
    when ``rotate``, over that many copies of ``x``."""
    got = kernel(x, idx)
    want = plain(x, idx)
    torch.cuda.synchronize()
    ok = torch.equal(got, want)
    row_bytes = x[0].numel() * x.element_size()
    record(name, (out_rows,) + tuple(x.shape[1:]), x.dtype,
           0.0 if ok else float((got.float() - want.float()).abs().max()),
           ok, "bitwise", lambda: kernel(x, idx), lambda: plain(x, idx),
           2 * out_rows * row_bytes + out_rows * idx.element_size(), 0,
           library=lambda: torch.index_select(x, 0, idx.reshape(-1)),
           rotated=gather_rotated(kernel, rotations(x, rotate), idx)
           if rotate else None)
    return got


def check_bucket(rows, feat, dtype, sc, pad, rotate=0):
    """K4a at (S, cap) = ``sc`` from ``rows`` rows (repeated rows when
    S*cap > rows, as slack-buffered plans have), then K4b back from the
    flat block (plus the zero pad row when ``pad``, which K4b then reads)
    into ``rows`` rows, each against its plain gather, bitwise. Indices
    are int32, the route plan's dtype. ``rotate``: also time each over
    that many copies of its input."""
    x = torch.randn((rows,) + feat, device=DEV).to(dtype)
    k = sc[0] * sc[1]
    idx = (torch.randperm(rows, device=DEV)[:k] if k <= rows else
           torch.randint(0, rows, (k,), device=DEV)).to(torch.int32)
    idx = idx.reshape(sc)
    got = check_gather_row("bucket_permute", perm_k.bucket_permute,
                           perm_ref.bucket_permute, x, idx, k, rotate)
    flat = torch.cat([got, torch.zeros_like(got[:pad])])
    ridx = torch.randperm(flat.shape[0], device=DEV)[:rows].to(torch.int32)
    if pad:
        ridx[0] = flat.shape[0] - 1
    check_gather_row("unbucket_permute", perm_k.unbucket_permute,
                     perm_ref.unbucket_permute, flat, ridx, rows, rotate)


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


def check_rmsnorm(rows, d, dtype, offset=0.0):
    """K6 against its plain version: 1e-5 in f32, 1 ulp in bf16."""
    x = torch.randn(rows, d, device=DEV).to(dtype)
    scale = torch.randn(d, device=DEV) * 0.1 + 1.0
    lib_scale = scale.to(dtype)          # the fused library call's weight
    got = rms_k.rmsnorm(x, scale, scale_offset=offset)
    want = rms_ref.rmsnorm_ref(x, scale, scale_offset=offset)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        tol, (err, ok) = "1e-5", compare(got, want, 1e-5, 1e-5)
    else:
        tol = f"1 ulp of {dtype}"
        err, ok = compare(got, want, ulp(dtype), torch.finfo(dtype).tiny)
    record("rmsnorm", x.shape, dtype, err, ok, tol,
           lambda: rms_k.rmsnorm(x, scale, scale_offset=offset),
           lambda: rms_ref.rmsnorm_ref(x, scale, scale_offset=offset),
           2 * x.numel() * x.element_size() + d * 4, 4 * x.numel(),
           library=lambda: torch.nn.functional.rms_norm(x, (d,), lib_scale,
                                                        1e-6))


def attention_pairs(sq, skv, causal, window):
    """(query, key) pairs the causal, window and length masks leave: the
    work this input needs (the kernel skips dead tiles, not dead pairs)."""
    iq = torch.arange(sq, dtype=torch.int64)
    lo = (iq - window + 1).clamp_min(0) if window else torch.zeros_like(iq)
    hi = iq.clamp_max(skv - 1) if causal else torch.full_like(iq, skv - 1)
    return int((hi - lo + 1).clamp_min(0).sum())


def attention_plain_by_head(q, k, v, causal, window):
    """The plain version one q head at a time: at S = 32768 the whole
    (B, H, S, S) f32 score tensor would be 137 GB."""
    g = q.shape[2] // k.shape[2]
    return torch.cat([flash_ref.attention_ref(
        q[:, :, h:h + 1], k[:, :, h // g:h // g + 1],
        v[:, :, h // g:h // g + 1], causal=causal, window=window)
        for h in range(q.shape[2])], dim=2)


def sdpa_gqa(q, k, v, causal, mask=None):
    """The library yardstick: one fused SDPA call with GQA, on its flash or
    memory-efficient backends only (the math backend would materialise the
    scores); with ``mask`` (a sliding window, which SDPA has no flag for)
    an additive (Sq, Skv) mask instead of ``causal``. Timed here, used
    nowhere in the port."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                      SDPBackend.EFFICIENT_ATTENTION,
                      SDPBackend.CUDNN_ATTENTION]):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True)


def sdpa_yardstick(q, k, v, causal, window):
    """A call of ``sdpa_gqa`` that some fused backend takes on these
    inputs, or None. A window goes in as a mask; where no backend takes
    GQA with a mask, k and v are repeated to the q heads first (outside
    the timed call)."""
    mask = None
    if window:       # additive, in q's dtype: no conversion in the call
        iq = torch.arange(q.shape[1], device=DEV)[:, None]
        ik = torch.arange(k.shape[1], device=DEV)[None, :]
        live = (iq - ik < window) & ((iq >= ik) if causal else True)
        mask = torch.zeros(live.shape, dtype=q.dtype, device=DEV)
        mask.masked_fill_(~live, float("-inf"))
    g = q.shape[2] // k.shape[2]
    for kv in ((k, v), (k.repeat_interleave(g, 2), v.repeat_interleave(g, 2))):
        try:
            sdpa_gqa(q, *kv, causal, mask)
            return lambda: sdpa_gqa(q, *kv, causal, mask)
        except RuntimeError as e:      # no fused backend takes these inputs
            print(f"  SDPA yardstick unavailable at {tuple(q.shape)} with "
                  f"{kv[0].shape[2]} kv heads, mask {mask is not None}: "
                  f"{str(e).splitlines()[0][:200]}")
        if g == 1:
            break
    return None


def check_flash(b, s, h, kh, d, dtype, causal=True, window=None, time=True,
                library=False, packed=False):
    """K7 against its plain version on random (B, S, heads, D) inputs:
    2e-3 in f32, 2e-2 in bf16 (tests/test_kernels.py's bounds). With
    ``packed``, q, k and v are views of one (B, S, H + 2K, D) projection,
    read through their strides. Returns the max error; with ``time``, also
    times and prints the row."""
    if packed:
        qkv = torch.randn(b, s, h + 2 * kh, d, device=DEV).to(dtype)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
    else:
        q, k, v = (torch.randn(b, s, n, d, device=DEV).to(dtype)
                   for n in (h, kh, kh))
    big = b * h * s * s >= 2 ** 31
    plain = (attention_plain_by_head if big else
             lambda *a: flash_ref.attention_ref(*a[:3], causal=a[3],
                                                window=a[4]))
    got = flash_k.flash_attention(q, k, v, causal=causal, window=window)
    want = plain(q, k, v, causal, window)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    err, ok = compare(got, want, tol, tol)
    if not ok:
        raise AssertionError(f"flash_attention {(b, s, h, kh, d)} {dtype} "
                             f"causal={causal} window={window}: max err "
                             f"{err} (tol {tol})")
    if not time:
        return err
    lib = sdpa_yardstick(q, k, v, causal, window) if library else None
    pairs = attention_pairs(s, s, causal, window)
    record("flash_attention", (b, s, h, kh, d), dtype, err, ok,
           f"{tol} abs + rel",
           lambda: flash_k.flash_attention(q, k, v, causal=causal,
                                           window=window),
           lambda: plain(q, k, v, causal, window),
           2 * (q.numel() + k.numel()) * q.element_size(),
           4 * b * h * d * pairs, library=lib,
           peak="bfloat16" if dtype == torch.bfloat16 else "float32",
           heavy=big or s >= 4096)
    return err


# The prefill cut: the repo's prefill_32k shape is B 32 x S 32768; here
# B 4 x S 4096 (PERF.md section 4), for qwen3-8b and xlstm-1.3b alike.
LM_BATCH, LM_SEQ = 4, 4096


def kernels_lm():
    """K6 at qwen3-8b's norm shapes and the ragged widths of the JAX tests;
    K7 at the prefill's shape, one long sequence, and the fuzz grid; K7 at
    head_dim 256 at gemma-7b's and recurrentgemma-9b's shapes and over its
    tile edges."""
    main = {}
    check_rmsnorm(16384, 4096, torch.bfloat16)
    main["rmsnorm"] = RESULTS[-1]
    check_rmsnorm(524288, 128, torch.bfloat16)
    for rows, d in ((37, 100), (33, 300)):
        for offset in (0.0, 1.0):
            check_rmsnorm(rows, d, torch.float32, offset)
    # the prefill's shape (phase 8), batch 1 of it, and one long sequence
    check_flash(LM_BATCH, LM_SEQ, 32, 8, 128, torch.bfloat16, library=True)
    main["flash_attention"] = RESULTS[-1]
    check_flash(1, LM_SEQ, 32, 8, 128, torch.bfloat16, library=True)
    check_flash(1, 32768, 32, 8, 128, torch.bfloat16, library=True)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for s in (16, 100):
            for h, kh in ((4, 2), (8, 1), (4, 4)):
                for d in (32, 64):
                    for causal in (True, False):
                        for window in (None, 16):
                            err = check_flash(2, s, h, kh, d, dtype, causal,
                                              window, time=False)
                            worst[dtype] = max(worst.get(dtype, 0.0), err)
        check_flash(2, 100, 8, 1, 64, dtype, window=16)
    print("flash_attention fuzz grid (S 16/100, H/K 4/2 8/1 4/4, D 32/64, "
          "causal or not, window none/16): max err " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items()))
    # the Hopper kernel's ragged edges at the prefill's head dim: S around
    # its 128-row and 128-key tiles, both GQA groupings, both masks
    worst = 0.0
    for s in (100, 127, 128, 129, 255, 1000):
        for h, kh in ((32, 8), (8, 1)):
            for causal in (True, False):
                for window in (None, 64):
                    worst = max(worst, check_flash(
                        2, s, h, kh, 128, torch.bfloat16, causal, window,
                        time=False))
    worst = max(worst, check_flash(2, 1000, 32, 8, 128, torch.bfloat16,
                                   time=False, packed=True))
    print(f"flash_attention bf16 D 128 grid (S 100/127/128/129/255/1000, "
          f"H/K 32/8 8/1, causal or not, window none/64, and a packed-qkv "
          f"view at S 1000): max err {worst:.3e} (tol 2e-2)")
    # head_dim 256 on the Hopper kernel (64-key K / V tiles): gemma-7b's
    # prefill attention (16 heads, MHA) at batch 1 and at the prefill's
    # shape (phase 14), and recurrentgemma-9b's local attention (16 heads
    # over 1, window 2048), each beside SDPA; then the grid of PR 16 (S
    # 31-200 and 2500, both dtypes) and one over the Hopper kernel's edges
    check_flash(1, LM_SEQ, 16, 16, 256, torch.bfloat16, library=True)
    check_flash(LM_BATCH, LM_SEQ, 16, 16, 256, torch.bfloat16, library=True)
    main["flash_attention_d256"] = RESULTS[-1]
    check_flash(1, LM_SEQ, 16, 1, 256, torch.bfloat16, window=2048,
                library=True)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for s in (31, 64, 65, 200):
            for h, kh in ((4, 4), (4, 1)):
                for causal in (True, False):
                    for window in (None, 40):
                        err = check_flash(2, s, h, kh, 256, dtype, causal,
                                          window, time=False)
                        worst[dtype] = max(worst.get(dtype, 0.0), err)
        worst[dtype] = max(worst[dtype], check_flash(
            1, 2500, 4, 1, 256, dtype, window=2048, time=False))
        worst[dtype] = max(worst[dtype], check_flash(
            2, 77, 4, 2, 256, dtype, time=False, packed=True))
    print("flash_attention D 256 grid (S 31/64/65/200, H/K 4/4 4/1, causal "
          "or not, window none/40; S 2500 window 2048; a packed-qkv view): "
          "max err " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + " (tol 2e-3 f32, 2e-2 bf16)")
    # the Hopper kernel's ragged edges at D 256: S around its 64-key K / V
    # and 128-row q tiles, where two key tiles cross a q tile's diagonal
    worst = 0.0
    for s in (63, 64, 65, 127, 128, 129, 1000):
        for h, kh in ((4, 4), (4, 1)):
            for causal in (True, False):
                for window in (None, 40):
                    worst = max(worst, check_flash(
                        2, s, h, kh, 256, torch.bfloat16, causal, window,
                        time=False))
    print(f"flash_attention bf16 D 256 grid on the Hopper kernel (S 63/64/"
          f"65/127/128/129/1000, H/K 4/4 4/1, causal or not, window "
          f"none/40): max err {worst:.3e} (tol 2e-2)")
    return main


def check_slstm(b, s, h, dh, scale=None, time=True, fused=False):
    """K8 against its plain version on random (B, S, H, Dh) f32 inputs,
    within 3e-4 (tests/test_kernels.py's kernel-to-ref bound). R is drawn
    at the model's scale, 1/sqrt(Dh), unless ``scale`` (the JAX test's
    0.3) is given; ``fused``: the four preactivations are views of one
    (B, S, H, 4 Dh) projection, as the model's could be. Returns the max
    error; with ``time``, also times and prints the row (work: 2 B 4 H Dh^2
    S FLOPs of recurrent products), its time a step and its share of the
    bound."""
    gen = torch.Generator(device=DEV).manual_seed(b * 1000 + s + dh)
    if fused:
        x = torch.randn(b, s, h, 4 * dh, device=DEV, generator=gen)
        pres = [x[..., g * dh:(g + 1) * dh] for g in range(4)]
    else:
        pres = [torch.randn(b, s, h, dh, device=DEV, generator=gen)
                for _ in range(4)]
    R = torch.randn(4, h, dh, dh, device=DEV, generator=gen) * (
        dh ** -0.5 if scale is None else scale)

    def plain():
        return slstm_ref.slstm_scan_ref(*pres, R, slstm_ref.initial_state(
            b, h, dh, DEV))[0]
    got = slstm_k.slstm_scan(*pres, R)
    want = plain()
    torch.cuda.synchronize()
    err, ok = compare(got, want, 3e-4, 3e-4)
    if not ok:
        raise AssertionError(f"slstm_scan {(b, s, h, dh)}: max err {err} "
                             f"(tol 3e-4)")
    if not time:
        return err
    record("slstm_scan", (b, s, h, dh), torch.float32, err, ok,
           "3e-4 abs + rel",
           lambda: slstm_k.slstm_scan(*pres, R), plain,
           5 * got.numel() * 4 + R.numel() * 4, 2 * b * 4 * h * dh * dh * s,
           heavy=True)
    row = RESULTS[-1]
    print(f"slstm_scan {(b, s, h, dh)}: {row['ms'] / s * 1e3:.3f} us a step, "
          f"{100 * row['bound_ms'] / row['ms']:.2f} % of the bound; plan "
          f"{slstm_k.card_plan(b, h, dh)}")
    return err


def slstm_anatomy(ms):
    """K8's time a step at the prefill shape (``ms`` a launch) beside the
    same launch with one step (the one-time loads of R), one batch row
    (the same plan and products, a quarter of the h words exchanged) and
    one head (which the plan cuts into narrower slices over as many SMs:
    a quarter of the products a block, the same exchange). Eager, 3
    calls; each with its plan's units and blocks."""
    def one(b, s, h):
        gen = torch.Generator(device=DEV).manual_seed(7)
        pres = [torch.randn(b, s, h, 512, device=DEV, generator=gen)
                for _ in range(4)]
        R = torch.randn(4, h, 512, 512, device=DEV, generator=gen) / 512 ** .5
        pl = slstm_k.card_plan(b, h, 512)
        return (eager_ms(lambda: slstm_k.slstm_scan(*pres, R), iters=3),
                f"{pl.units} units x {pl.groups * h * pl.slices} blocks")
    (s1, _), (b1, b1_plan), (h1, h1_plan) = (
        one(LM_BATCH, 1, 4), one(1, LM_SEQ, 4), one(LM_BATCH, LM_SEQ, 1))
    step = (ms - s1) / (LM_SEQ - 1) * 1e3
    print(f"slstm_scan anatomy at B {LM_BATCH}, S {LM_SEQ}, H 4, Dh 512: "
          f"{step:.3f} us a step after a {s1 * 1e3:.1f} us first step; "
          f"B 1 ({b1_plan}): {b1 / LM_SEQ * 1e3:.3f} us a step; H 1 "
          f"({h1_plan}): {h1 / LM_SEQ * 1e3:.3f} us a step")


def kernels_xlstm():
    """K8 at xlstm-1.3b's prefill shape (phase 11: B 4 x S 4096, 4 heads,
    Dh 512), the fuzz grid of tests/test_kernels.py plus Dh 64 (the smoke
    config's), and the launch plan's edges at the model's width: B 1 and
    5, S 1, a ragged last slice (Dh 509), two launches (H 12), the
    preactivations as views of one fused projection, and slices of more
    than 32 units at 4 rows a block (H 40, Dh 128), whose 4 x 4 units
    partial-sum totals outnumber a block's threads."""
    check_slstm(LM_BATCH, LM_SEQ, 4, 512)
    main = {"slstm_scan": RESULTS[-1]}
    slstm_anatomy(main["slstm_scan"]["ms"])
    worst = 0.0
    for b in range(1, 6):
        for s in (4, 20, 64, 70):
            for h, dh in ((2, 8), (4, 16), (1, 32), (2, 64)):
                worst = max(worst, check_slstm(b, s, h, dh, scale=0.3,
                                               time=False))
    print(f"slstm_scan fuzz grid (B 1-5, S 4/20/64/70, H/Dh 2/8 4/16 1/32 "
          f"2/64, R at 0.3): max err {worst:.3e} (tol 3e-4)")
    edges = {}
    for name, (b, s, h, dh, fused) in {
            "B 1": (1, 64, 4, 512, False), "B 5": (5, 64, 4, 512, False),
            "S 1": (4, 1, 4, 512, False), "Dh 509": (4, 64, 4, 509, False),
            "H 12": (2, 64, 12, 512, False),
            "fused views": (3, 64, 4, 512, True),
            "units > 32": (4, 64, 40, 128, False)}.items():
        pl = slstm_k.card_plan(b, h, dh)
        edges[name] = (check_slstm(b, s, h, dh, time=False, fused=fused),
                       pl.units, dh - (pl.slices - 1) * pl.units,
                       len(pl.launches))
    if (edges["H 12"][3] < 2 or edges["Dh 509"][2] == edges["Dh 509"][1]
            or 16 * edges["units > 32"][1] <= slstm_k.THREADS):
        raise AssertionError(f"the plan-edge shapes missed their edge: "
                             f"{edges}")
    print("slstm_scan plan edges (max err, units, last slice's units, "
          "launches): " + "; ".join(
              f"{k} {e:.3e} {u} {last} {n}"
              for k, (e, u, last, n) in edges.items()) + " (tol 3e-4)")
    return main


# Main-path shapes at full width: ResNet-56 (width 16, 100 classes), 100
# clients x batch 8, 32x32 images; the pool is 800 rows of 32*32*16.
POOL, HW, WIDTH, CLASSES, CLIENTS, BATCH = 800, 32, 16, 100, 100, 8


def kernels_vs_plain():
    phase("2. kernels against their plain versions (full width + ragged)")
    main = {}
    for dtype in (torch.bfloat16, torch.float32):
        pool_bf16 = ROTATE if dtype == torch.bfloat16 else 0
        check_permute(POOL, (HW, HW, WIDTH), dtype, rotate=pool_bf16)
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
        if dtype == torch.bfloat16:     # K3f's block edges: 4 rows / 1 row
            for rows, v in ((1, 13), (33, 100), (1000, 1000)):
                check_xent(rows, v, dtype)
        # past the one-block width: a GPT-2-sized vocabulary
        check_xent(64, 50257, dtype)
        # the sharded path at world size 1: one bucket of the 800-row pool
        check_bucket(POOL, (HW, HW, WIDTH), dtype, (1, POOL), pad=0,
                     rotate=pool_bf16)
        if dtype == torch.bfloat16:
            main["bucket_permute"], main["unbucket_permute"] = \
                RESULTS[-2], RESULTS[-1]
        # a slack-buffered plan: 4 buckets of 220 from 800 rows (repeated
        # rows), and K4b reading the zero pad row
        check_bucket(POOL, (HW, HW, WIDTH), dtype, (4, 220), pad=1)
        check_bucket(37, (5, 7, 3), dtype, (4, 10), pad=1)
        for wire in ("int8", "float8_e4m3"):
            check_quant(POOL, HW * HW * WIDTH, dtype, wire, (1, POOL), 0)
            if dtype == torch.bfloat16 and wire == "int8":
                main["quant_bucket_permute"] = RESULTS[-2]
                main["dequant_unbucket_permute"] = RESULTS[-1]
            check_quant(37, 105, dtype, wire, (4, 10), 1)
    # K3b beside the design it replaced (and, past MAX_V classes, one row
    # a program looping over its column blocks), in turns on the same inputs
    for row in xent_probe.compare():
        print("K3b designs " + json.dumps(row), flush=True)
    main.update(kernels_lm())
    main.update(kernels_xlstm())
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


def profile_steps(epoch, steps=2, what="warm steps"):
    """Device time by kernel over ``steps`` warm SFPL steps (or one call of
    another path, named by ``what``): ``epoch(steps)`` under
    torch.profiler, and the device's busy share of the wall time."""
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
    print(f"profile over {steps} {what}: wall {wall_us / 1e3:.1f} ms, "
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
    by_name = {}
    for name, sym in SYMBOL.items():
        us = sum(r[1] for r in rows if sym in r[0])
        n = sum(r[2] for r in rows if sym in r[0])
        by_name[name] = (n, us)
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
    return by_name


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


def sharded_epoch(run, group, gen_seed, wire, steps=None, use_kernel=None,
                  **kw):
    """``sfpl_epoch_sharded`` over ``group`` (balanced mode, exact
    backward); ``use_kernel=False`` swaps the K4/K5 kernels for their
    plain versions; ``kw`` (``alpha``, ``collector_pipeline``,
    ``collector_submesh``) goes to the epoch."""
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
        device=DEV, **kw)


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
        seen = profile_steps(lambda k: sharded_epoch(run, group, 3, "int8",
                                                     steps=k))
        if not (seen["bucket_permute"][0] and seen["unbucket_permute"][0]):
            raise AssertionError(f"the sharded steps ran no K4a/K4b "
                                 f"kernel ({SYMBOL['bucket_permute']}"
                                 f", {SYMBOL['unbucket_permute']}): {seen}")
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


# --------------------------------------------------------------------------
# phases 8-10: qwen3-8b prefill and serving

def free_device_memory(before):
    """Collect what earlier phases left and print what is still held."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory in use before the phase ({before} freed): "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")


def lm_init(cfg, seed, arch="qwen3-8b"):
    """Random weights drawn on the card from ``seed`` (no host draw)."""
    spec = get_arch(arch)
    t0 = time.perf_counter()
    params = spec.model.init(torch.Generator(device=DEV).manual_seed(seed),
                             cfg)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"init {cfg.name} ({cfg.num_layers} layers): {n / 1e9:.3f} B "
          f"params, {n * 4 / 1e9:.1f} GB f32, on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    return params


def full_prefill(arch):
    """``arch`` at full width, f32 parameters drawn on the card from seed
    0, bf16 compute, attention through K7: one cold and two warm prefills
    through ``make_prefill_step`` at B LM_BATCH x S LM_SEQ (wall, tokens/s,
    peak memory), one K7 launch a layer, finite last-token logits, and a
    profile of a warm prefill. Returns (spec, cfg, params, tokens, logits,
    launches, profile by kernel)."""
    from repro_torch.launch.steps import make_prefill_step
    spec = get_arch(arch)
    cfg = spec.make_config(attention_impl="kernel")
    params = lm_init(cfg, seed=0, arch=arch)
    gen = torch.Generator(device=DEV).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                         generator=gen, device=DEV)
    batch = {"tokens": toks}
    prefill = make_prefill_step(spec, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    warm = min(walls)
    n_tok = LM_BATCH * LM_SEQ
    print(f"prefill wall cold {cold:.3f} s, warm {walls[0]:.3f} and "
          f"{walls[1]:.3f} s ({n_tok / warm:.0f} tokens/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    # the stacked (num_groups, in, out) weights of the layers
    dense = sum(a.numel() for a in tree_leaves(params["layers"])
                if a.dim() == 3)
    head = 2 * LM_BATCH * cfg.d_model * cfg.vocab_size
    print(f"dense matmul FLOPs per prefill: {2 * n_tok * dense:.3e} in "
          f"the layers, {head:.3e} in the last-token unembedding")
    print(f"launches in one prefill: flash_attention "
          f"{launches['flash_attention']}, rmsnorm {launches['rmsnorm']} "
          f"(no model calls K6, as in the JAX package)")
    if launches["flash_attention"] != cfg.num_layers:
        raise AssertionError(f"prefill launched K7 "
                             f"{launches['flash_attention']} times, "
                             f"not once per layer ({cfg.num_layers})")
    finite = bool(torch.isfinite(logits).all())
    if tuple(logits.shape) != (LM_BATCH, 1, cfg.vocab_size) or not finite:
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"finite={finite}")
    seen = profile_steps(lambda k: prefill(params, batch), steps=1,
                         what="warm prefill")
    return spec, cfg, params, toks, logits, launches, seen


def lm_prefill():
    phase(f"8. LM prefill: qwen3-8b full width (36 layers), f32 params, "
          f"bf16 compute, attention through K7, make_prefill_step, "
          f"B {LM_BATCH} x S {LM_SEQ}")
    import dataclasses
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.nn.linear import embedding_apply
    from repro_torch.nn.norm import rmsnorm_apply
    with torch.inference_mode():
        spec, cfg, params, toks, logits, launches, _ = full_prefill(
            "qwen3-8b")

        # the same prefill on the plain attention path, at batch 1 (its
        # f32 scores at S 4096 take 2 GB a layer): print only, bf16 over
        # 36 layers has no reference bound
        plain = make_prefill_step(spec, dataclasses.replace(
            cfg, attention_impl="xla"))(params, {"tokens": toks[:1]})
        d = float((plain - logits[:1]).abs().max())
        a, b = int(plain[0, -1].argmax()), int(logits[0, -1].argmax())
        print(f"last-token logits, K7 path (row 0 of the batch) against the "
              f"plain path (batch 1): max |diff| {d:.4e} of max |logit| "
              f"{float(plain.abs().max()):.3f}; argmax {b} vs {a} "
              f"({'agree' if a == b else 'differ'})")

        # K6's own path: its entry point rmsnorm_apply(use_kernel=True) at
        # the prefill's two norm shapes, the residual stream and qk-norm
        phase("8b. K6 through nn.norm.rmsnorm_apply(use_kernel=True) at the "
              "prefill's norm shapes (no model sets the flag, as in the JAX "
              "package)")
        x = embedding_apply(params["embed"], toks, compute_dtype=cfg.cdtype())
        lp = {k: a[0].to(cfg.cdtype()) for k, a in params["layers"]["sub0"]
              ["attn_norm"].items()}
        qn = {k: a[0].to(cfg.cdtype()) for k, a in params["layers"]["sub0"]
              ["attn"]["q_norm"].items()}
        xq = x.reshape(LM_BATCH, LM_SEQ, cfg.num_heads, cfg.head_dim)
        K.reset_launches()
        y1 = rmsnorm_apply(lp, x, eps=cfg.norm_eps, use_kernel=True)
        y2 = rmsnorm_apply(qn, xq, use_kernel=True)
        torch.cuda.synchronize()
        rms_launches = K.LAUNCHES["rmsnorm"]
        for got, want in ((y1, rmsnorm_apply(lp, x, eps=cfg.norm_eps)),
                          (y2, rmsnorm_apply(qn, xq))):
            err, ok = compare(got, want, ulp(got.dtype),
                              torch.finfo(got.dtype).tiny)
            print(f"rmsnorm_apply {tuple(got.shape)} {got.dtype}: kernel "
                  f"against plain max |diff| {err:.3e} (1 ulp)")
            if not ok:
                raise AssertionError("rmsnorm_apply(use_kernel=True) "
                                     "disagrees with the plain path")
        print(f"launches: rmsnorm {rms_launches}")
        if rms_launches != 2:
            raise AssertionError(f"rmsnorm_apply(use_kernel=True) launched "
                                 f"K6 {rms_launches} times, not 2")
    launches["rmsnorm"] = rms_launches
    del params, logits, plain, x, xq, y1, y2
    torch.cuda.empty_cache()
    return launches


def single_greedy(spec, cfg, params, prompt, max_new, max_len):
    """One request alone through ``decode_step`` at batch 1, greedy."""
    state = spec.model.init_decode_state(cfg, 1, max_len,
                                         dtype=torch.float32, device=DEV)
    out, cur, t = [], prompt[0], 0
    while len(out) < max_new:
        lg, state = spec.model.decode_step(
            params, state, torch.tensor([[cur]], device=DEV), cfg, cur_pos=t)
        t += 1
        if t < len(prompt):
            cur = prompt[t]
            continue
        cur = int(lg[0, -1].argmax())
        out.append(cur)
    return out


def lm_checks(arch="qwen3-8b", number="9"):
    phase(f"{number}. LM checks: {arch} at full width, 2 layers, f32 "
          f"compute: K7 prefill against the plain path, cached decode "
          f"against the forward, batched greedy against sequential")
    import dataclasses
    from repro_torch.serving import ContinuousBatcher, Request
    spec = get_arch(arch)
    cfg = spec.make_config(num_layers=2, compute_dtype="float32")
    b, s = 2, 200
    with torch.inference_mode():
        params = lm_init(cfg, seed=2, arch=arch)
        gen = torch.Generator(device=DEV).manual_seed(3)
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device=DEV)
        K.reset_launches()
        full_k, _ = spec.model.forward(params, {"tokens": toks},
                                       dataclasses.replace(
                                           cfg, attention_impl="kernel"))
        n_k7 = K.LAUNCHES["flash_attention"]
        full_x, _ = spec.model.forward(params, {"tokens": toks}, cfg)
        err, ok = compare(full_k, full_x, 2e-3, 2e-3)
        print(f"prefill logits (B {b}, S {s}, every position), K7 against "
              f"plain: max |diff| {err:.3e} (tol 2e-3; {n_k7} K7 launches)")
        if not ok or n_k7 != cfg.num_layers:
            raise AssertionError(f"K7 prefill differs from plain by {err} "
                                 f"({n_k7} launches)")
        state = spec.model.init_decode_state(cfg, b, s, dtype=torch.float32,
                                             device=DEV)
        dec = []
        for t in range(s):
            lg, state = spec.model.decode_step(params, state,
                                               toks[:, t:t + 1], cfg,
                                               cur_pos=t)
            dec.append(lg)
        err, ok = compare(torch.cat(dec, dim=1), full_x, 2e-3, 2e-3)
        print(f"cached decode fed the same {s} tokens against the forward: "
              f"max |diff| {err:.3e} (tol 2e-3)")
        if not ok:
            raise AssertionError(f"decode differs from forward by {err}")
        del full_k, full_x, dec, state
    rng = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in (3, 7, 5, 4, 6)]
    batcher = ContinuousBatcher(spec, cfg, params, num_slots=2, max_len=64)
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    for r in reqs:
        batcher.submit(r)
    done, ticks = batcher.run()
    with torch.inference_mode():
        seq = [single_greedy(spec, cfg, params, r.prompt, 6, 64)
               for r in reqs]
    same = [r.output == w for r, w in zip(reqs, seq)]
    print(f"ContinuousBatcher: {len(done)} requests through 2 slots in "
          f"{ticks} ticks; greedy outputs equal to sequential: {same}")
    if len(done) != len(reqs) or not all(same):
        raise AssertionError(f"batched greedy {[r.output for r in reqs]} "
                             f"!= sequential {seq}")
    del params
    torch.cuda.empty_cache()


def decode_profile(spec, cfg, params, batch=4, steps=3):
    """Where a full-width decode step's time goes: ``steps`` warm steps of
    ``decode_step`` at ``batch`` under torch.profiler."""
    with torch.inference_mode():
        state = spec.model.init_decode_state(cfg, batch, 96,
                                             dtype=torch.float32, device=DEV)
        tok = torch.zeros((batch, 1), dtype=torch.long, device=DEV)
        pos = iter(range(96))
        for _ in range(2):
            spec.model.decode_step(params, state, tok, cfg, cur_pos=next(pos))

        def run(k):
            for _ in range(k):
                spec.model.decode_step(params, state, tok, cfg,
                                       cur_pos=next(pos))
        profile_steps(run, steps=steps, what=f"warm decode steps (B {batch})")


def lm_serving():
    phase("10. serving at full width (36 layers, bf16): serve(), the "
          "ContinuousBatcher, and the serve entry point")
    from repro_torch.launch.serve import serve
    from repro_torch.serving import ContinuousBatcher, Request
    out = serve("qwen3-8b", batch=4, prompt_len=64, gen=32, smoke=False)
    if tuple(out.shape) != (4, 32) or int(out.min()) < 0 \
            or int(out.max()) >= 151936:
        raise AssertionError(f"serve returned {tuple(out.shape)} tokens in "
                             f"[{int(out.min())}, {int(out.max())}]")
    torch.cuda.empty_cache()

    spec = get_arch("qwen3-8b")
    cfg = spec.make_config()
    with torch.inference_mode():
        params = lm_init(cfg, seed=5)
    rng = torch.Generator().manual_seed(6)
    lens = (8, 64, 23, 40, 15, 57)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                         generator=rng).tolist(),
                    max_new_tokens=16) for n in lens]
    batcher = ContinuousBatcher(spec, cfg, params, num_slots=4, max_len=96)
    for r in reqs:
        batcher.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done, ticks = batcher.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    new = sum(len(r.output) for r in done)
    print(f"ContinuousBatcher: {len(done)} of {len(reqs)} requests (prompts "
          f"{list(lens)}, 16 new tokens each) through 4 slots in {ticks} "
          f"ticks, {wall:.2f} s ({wall / ticks * 1e3:.1f} ms/tick, "
          f"{new / wall:.1f} generated tok/s, "
          f"{(new + sum(lens)) / wall:.1f} tok/s with the prompts)")
    if len(done) != len(reqs) or any(len(r.output) != 16 for r in done):
        raise AssertionError("the batcher did not finish every request")
    decode_profile(spec, cfg, params)
    del params, batcher
    torch.cuda.empty_cache()

    env = dict(os.environ, PYTHONPATH=str(HERE / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-8b"], cwd=HERE, env=env, capture_output=True, text=True,
        timeout=300)
    print(res.stdout.strip())
    if res.returncode != 0 or "decoded" not in res.stdout:
        raise AssertionError(f"serve entry point exited {res.returncode}:\n"
                             f"{res.stderr[-4000:]}")


# --------------------------------------------------------------------------
# phases 11-13: xlstm-1.3b prefill and serving

XLSTM_PARAMS = 1_391_102_288      # jax.eval_shape of the JAX package's init


def xlstm_prefill():
    phase(f"11. xLSTM prefill: xlstm-1.3b full width (48 blocks: 42 mLSTM, "
          f"6 sLSTM), f32 params, bf16 compute, sLSTM through K8, "
          f"make_prefill_step, B {LM_BATCH} x S {LM_SEQ}")
    import dataclasses
    from repro_torch.launch.steps import make_prefill_step
    free_device_memory("qwen3-8b")
    spec = get_arch("xlstm-1.3b")
    cfg = spec.make_config(slstm_impl="kernel")
    n_slstm = cfg.num_layers // cfg.slstm_every
    with torch.inference_mode():
        params = lm_init(cfg, seed=0, arch="xlstm-1.3b")
        n = sum(t.numel() for t in tree_leaves(params))
        if n != XLSTM_PARAMS:
            raise AssertionError(f"xlstm-1.3b has {n} params, the JAX "
                                 f"package {XLSTM_PARAMS}")
        gen = torch.Generator(device=DEV).manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                             generator=gen, device=DEV)
        batch = {"tokens": toks}
        prefill = make_prefill_step(spec, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            prefill(params, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        warm = min(walls)
        n_tok = LM_BATCH * LM_SEQ
        print(f"prefill wall cold {cold:.3f} s, warm {walls[0]:.3f} and "
              f"{walls[1]:.3f} s ({n_tok / warm:.0f} tokens/s); peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(f"launches in one prefill: slstm_scan "
              f"{launches['slstm_scan']} (one per sLSTM block, {n_slstm})")
        if launches["slstm_scan"] != n_slstm:
            raise AssertionError(f"prefill launched K8 "
                                 f"{launches['slstm_scan']} times, not "
                                 f"once per sLSTM block ({n_slstm})")
        finite = bool(torch.isfinite(logits).all())
        if tuple(logits.shape) != (LM_BATCH, 1, cfg.vocab_size) \
                or not finite:
            raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                                 f"finite={finite}")
        seen = profile_steps(lambda k: prefill(params, batch), steps=1,
                             what="warm prefill")
        n_k8, us_k8 = seen["slstm_scan"]
        print(f"K8 ({SYMBOL['slstm_scan']}) in the warm prefill's profile: "
              f"{us_k8 / 1e3:.3f} ms of device time over {n_k8} launches "
              f"({us_k8 / 1e3 / max(n_k8, 1):.3f} ms a launch)")
        if n_k8 != n_slstm:
            raise AssertionError(f"the prefill's profile shows {n_k8} K8 "
                                 f"launches, not {n_slstm}")

        # the same prefill on the plain sLSTM path: print only, bf16 over
        # 48 blocks has no reference bound
        t0 = time.perf_counter()
        plain = make_prefill_step(spec, dataclasses.replace(
            cfg, slstm_impl="xla"))(params, batch)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        d = float((plain - logits).abs().max())
        scale = float(plain.abs().max())
        same = (plain[:, -1].argmax(-1) == logits[:, -1].argmax(-1)).tolist()
        print(f"last-token logits, K8 path against the plain sLSTM path "
              f"({t_plain:.1f} s): max |diff| {d:.4e} of max |logit| "
              f"{scale:.3f} ({d / scale:.3e}); argmax equal per row {same}")
    del params, logits, plain
    torch.cuda.empty_cache()
    return launches


def xlstm_checks():
    phase("12. xLSTM checks at full width, 1 group (7 mLSTM + 1 sLSTM), f32 "
          "compute: K8 prefill against the plain path, cached decode "
          "against the forward")
    import dataclasses
    spec = get_arch("xlstm-1.3b")
    cfg = spec.make_config(num_layers=8, compute_dtype="float32")
    b, s = 2, 200
    with torch.inference_mode():
        params = lm_init(cfg, seed=2, arch="xlstm-1.3b")
        gen = torch.Generator(device=DEV).manual_seed(3)
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device=DEV)
        K.reset_launches()
        full_k, _ = spec.model.forward(params, {"tokens": toks},
                                       dataclasses.replace(
                                           cfg, slstm_impl="kernel"))
        n_k8 = K.LAUNCHES["slstm_scan"]
        full_x, _ = spec.model.forward(params, {"tokens": toks}, cfg)
        err, ok = compare(full_k, full_x, 2e-3, 2e-3)
        print(f"prefill logits (B {b}, S {s}, every position), K8 against "
              f"plain: max |diff| {err:.3e} (tol 2e-3; {n_k8} K8 launch)")
        if not ok or n_k8 != 1:
            raise AssertionError(f"K8 prefill differs from plain by {err} "
                                 f"({n_k8} launches)")
        state = spec.model.init_decode_state(cfg, b, device=DEV)
        dec = []
        t0 = time.perf_counter()
        for t in range(s):
            lg, state = spec.model.decode_step(params, state,
                                               toks[:, t:t + 1], cfg)
            dec.append(lg)
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
        err, ok = compare(torch.cat(dec, dim=1), full_x, 5e-3, 5e-3)
        print(f"cached decode fed the same {s} tokens against the forward: "
              f"max |diff| {err:.3e} (tol 5e-3; {t_dec / s * 1e3:.1f} "
              f"ms/step at 8 blocks)")
        if not ok:
            raise AssertionError(f"decode differs from forward by {err}")
    del params, full_k, full_x, dec, state
    torch.cuda.empty_cache()


def xlstm_serving():
    phase("13. xLSTM serving at full width (48 blocks, bf16): serve(), a "
          "decode profile, and the serve entry point")
    from repro_torch.launch.serve import serve
    out = serve("xlstm-1.3b", batch=4, prompt_len=64, gen=32, smoke=False)
    if tuple(out.shape) != (4, 32) or int(out.min()) < 0 \
            or int(out.max()) >= 50304:
        raise AssertionError(f"serve returned {tuple(out.shape)} tokens in "
                             f"[{int(out.min())}, {int(out.max())}]")
    torch.cuda.empty_cache()
    spec = get_arch("xlstm-1.3b")
    cfg = spec.make_config()
    with torch.inference_mode():
        params = lm_init(cfg, seed=5, arch="xlstm-1.3b")
        state = spec.model.init_decode_state(cfg, 4, device=DEV)
        logits, _ = spec.model.decode_step(
            params, state, torch.zeros((4, 1), dtype=torch.long,
                                       device=DEV), cfg)
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError("full-width decode logits are not finite")
    decode_profile(spec, cfg, params)
    del params, state, logits
    torch.cuda.empty_cache()

    env = dict(os.environ, PYTHONPATH=str(HERE / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "xlstm-1.3b", "--full"], cwd=HERE, env=env, capture_output=True,
        text=True, timeout=300)
    print(res.stdout.strip())
    if res.returncode != 0 or "decoded" not in res.stdout:
        raise AssertionError(f"serve entry point exited {res.returncode}:\n"
                             f"{res.stderr[-4000:]}")


# --------------------------------------------------------------------------
# phases 14-16: gemma-7b prefill, checks and serving; minitron-8b and
# phi3-medium-14b prefills

def gemma_prefill():
    phase(f"14. LM prefill: gemma-7b full width (28 layers, 16/16 heads, "
          f"head_dim 256), f32 params, bf16 compute, attention through K7 "
          f"at D 256, make_prefill_step, B {LM_BATCH} x S {LM_SEQ}")
    free_device_memory("qwen3-8b and xlstm-1.3b")
    with torch.inference_mode():
        _, cfg, params, _, logits, launches, seen = full_prefill("gemma-7b")
    n_k7, us_k7 = seen["flash_attention"]
    print(f"K7 ({SYMBOL['flash_attention']}) in the warm prefill's profile: "
          f"{us_k7 / 1e3:.3f} ms of device time over {n_k7} launches "
          f"({us_k7 / 1e3 / max(n_k7, 1):.3f} ms a launch; its share of "
          f"device time is on the profile's flash_attention line)")
    if n_k7 != cfg.num_layers:
        raise AssertionError(f"the prefill's profile shows {n_k7} K7 "
                             f"launches, not {cfg.num_layers}")
    del params, logits
    torch.cuda.empty_cache()
    return launches


def bf16_prefill_check(arch, b, s, layers=2):
    """``arch`` at full width and ``layers`` layers, bf16 compute: the
    prefill's logits at every position through K7 against the plain
    attention path, finite and within 2e-2 of max |logit|, the bound of
    tests/test_torch_lm.py::test_prefill_logits_match_jax_bf16 (ROADMAP
    section 3: bf16 logits are held relative to their scale)."""
    import dataclasses
    spec = get_arch(arch)
    cfg = spec.make_config(num_layers=layers)
    with torch.inference_mode():
        params = lm_init(cfg, seed=7, arch=arch)
        toks = torch.randint(0, cfg.vocab_size, (b, s), device=DEV,
                             generator=torch.Generator(device=DEV)
                             .manual_seed(8))
        K.reset_launches()
        got, _ = spec.model.forward(params, {"tokens": toks},
                                    dataclasses.replace(
                                        cfg, attention_impl="kernel"))
        n_k7 = K.LAUNCHES["flash_attention"]
        want, _ = spec.model.forward(params, {"tokens": toks}, cfg)
    gap = float((got - want).abs().max())
    scale = float(want.abs().max())
    finite = bool(torch.isfinite(got).all())
    print(f"{arch} bf16 prefill ({layers} layers, B {b}, S {s}, head_dim "
          f"{cfg.head_dim}, every position), K7 against plain: max |diff| "
          f"{gap:.4e} of max |logit| {scale:.3f} ({gap / scale:.3e}; bound "
          f"2e-2); finite {finite}; {n_k7} K7 launches")
    if not finite or gap > 2e-2 * scale or n_k7 != layers:
        raise AssertionError(f"{arch} bf16 prefill through K7: gap {gap}, "
                             f"scale {scale}, finite {finite}, {n_k7} "
                             f"launches")
    del params, got, want
    torch.cuda.empty_cache()


def gemma_checks():
    lm_checks("gemma-7b", number="15")
    bf16_prefill_check("gemma-7b", 2, 512)
    phase("15b. minitron-8b (relu2, 32/8 heads) and phi3-medium-14b "
          "(SwiGLU, 40/10 heads) at full width, 2 layers, bf16: one "
          "prefill each through K7 at D 128 against the plain path")
    for arch in ("minitron-8b", "phi3-medium-14b"):
        bf16_prefill_check(arch, 2, 512)


def gemma_serving():
    phase("16. gemma-7b serving at full width (28 layers, bf16): serve() at "
          "batch 4, prompt 64, 32 new tokens")
    from repro_torch.launch.serve import serve
    out = serve("gemma-7b", batch=4, prompt_len=64, gen=32, smoke=False)
    if tuple(out.shape) != (4, 32) or int(out.min()) < 0 \
            or int(out.max()) >= 256000:
        raise AssertionError(f"serve returned {tuple(out.shape)} tokens in "
                             f"[{int(out.min())}, {int(out.max())}]")
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phases 17-19: the paper's comparison, the streamed collector, the
# entry points of both

def paper_comparison(smi):
    phase("17. launch.eval.evaluate_paper: SFPL against SFLv2, ResNet-56 "
          "width 16, 100 clients x batch 8, 32x32, bf16, kernels on, 2 "
          "epochs, one device")
    print(f"card: {smi} (every time below was taken on it)")
    from repro_torch.launch.eval import evaluate_paper
    kw = dict(depth=56, width=WIDTH, hw=HW, batch_size=BATCH,
              compute_dtype="bfloat16", use_kernel=True)
    K.reset_launches()
    rep = evaluate_paper(num_clients=CLIENTS, epochs=2, **kw)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    for scheme in ("sfpl", "sflv2"):
        r = rep[scheme]
        print(f"  {scheme:5s} IID {r['iid']['accuracy']:.3f}%  non-IID "
              f"{r['noniid']['accuracy']:.3f}%  training wall "
              f"{r['seconds']:.3f} s ({smi})")
    print(f"launches: {launches}")
    keys = {"sfpl", "sflv2", "num_clients", "sharded"}
    if not keys <= set(rep) or rep["num_clients"] != CLIENTS:
        raise AssertionError(f"evaluate_paper returned {sorted(rep)}")
    for scheme in ("sfpl", "sflv2"):
        for proto in ("iid", "noniid"):
            acc = rep[scheme][proto]["accuracy"]
            if not (math.isfinite(acc) and 0.0 <= acc <= 100.0):
                raise AssertionError(f"{scheme} {proto} accuracy {acc}")
    missing = [k for k in SINGLE_DEVICE if launches[k] <= 0]
    if missing:
        raise AssertionError(f"evaluate_paper launched no {missing}")
    # the same kernels seen by the profiler, on a short run of the same
    # width (2 clients, 1 epoch): the profile of the full run would hold
    # over a million kernel records
    seen = profile_steps(lambda _: evaluate_paper(num_clients=2, epochs=1,
                                                  **kw),
                         steps=1, what="evaluate_paper calls (2 clients, "
                         "1 epoch)")
    missing = [k for k in SINGLE_DEVICE if not seen[k][0]]
    if missing:
        raise AssertionError(f"the profile shows no launch of {missing}: "
                             f"{seen}")
    return launches


def streamed_path(smi):
    phase("18. streamed collector: sfpl_epoch_sharded(collector_pipeline="
          "'double_buffered') on a world-size-1 NCCL group, ResNet-56 width "
          "16, 100 clients x batch 8, 32x32, bf16, 4 steps: sub-mesh (alpha "
          "1.0) and the whole-mesh fallback (alpha 0.5), exact and int8 "
          "wire, each against the sync exchange")
    print(f"card: {smi} (every time below was taken on it)")
    from repro_torch.core import engine_dist as ED
    run = build_run(56, CLIENTS, HW)
    steps = 4
    row = HW * HW * WIDTH
    n = CLIENTS * BATCH
    cases = [("sub-mesh, alpha 1.0", 1.0, None),
             ("fallback, alpha 0.5", 0.5, False)]
    group = ED.init_data_group(DEV)
    try:
        # NCCL communicators start at first use: one epoch of each path
        # before anything is timed or compared
        for _, alpha, submesh in cases:
            sharded_epoch(run, group, 9, None, alpha=alpha)
            sharded_epoch(run, group, 9, None, alpha=alpha,
                          collector_pipeline="double_buffered",
                          collector_submesh=submesh)
        torch.cuda.synchronize()
        # cuDNN deterministic for the comparisons only (as phase 6)
        torch.backends.cudnn.deterministic = True
        launches = {}
        for wire in (None, "int8"):
            for name, alpha, submesh in cases:
                _, l_sync = sharded_epoch(run, group, 1, wire, alpha=alpha)
                K.reset_launches()
                _, l_str = sharded_epoch(run, group, 1, wire, alpha=alpha,
                                         collector_pipeline="double_buffered",
                                         collector_submesh=submesh)
                torch.cuda.synchronize()
                launches[name, wire] = dict(K.LAUNCHES)
                l_sync, l_str = l_sync.float().cpu(), l_str.float().cpu()
                d = float((l_str - l_sync).abs().max())
                print(f"  {name}, wire {wire or 'exact'}: streamed "
                      f"{l_str.tolist()} sync {l_sync.tolist()} max |diff| "
                      f"{d:.3e} (must be 0)")
                if not bool(torch.isfinite(l_str).all()):
                    raise AssertionError(f"non-finite losses {l_str}")
                if d != 0.0:
                    raise AssertionError(
                        f"{name}, wire {wire}: streamed losses differ from "
                        f"the sync exchange's by {d}")
                ours = (("bucket_permute", "unbucket_permute")
                        if wire is None else ("quant_bucket_permute",
                                              "dequant_unbucket_permute"))
                missing = [k for k in ours if launches[name, wire][k] <= 0]
                if missing:
                    raise AssertionError(f"{name}, wire {wire}: the streamed "
                                         f"path launched no {missing}")
        torch.backends.cudnn.deterministic = False
        print("launches per streamed epoch: " + "; ".join(
            f"{name} {wire or 'exact'}: " + ", ".join(
                f"{k} {v}" for k, v in counts.items() if v)
            for (name, wire), counts in launches.items()))

        for name, alpha, submesh in cases:
            coll = group.collector(CLIENTS, alpha=alpha,
                                   pipeline="double_buffered",
                                   submesh=submesh)
            sync = group.collector(CLIENTS, alpha=alpha)
            perm = coll.make_perm(torch.Generator().manual_seed(1), n, DEV)
            prep = coll.prepare(perm, n)
            bf16 = torch.bfloat16
            print(f"  {name}: exchange bytes per step (bf16 rows) "
                  f"{coll.exchange_bytes(prep, row, bf16)} streamed, "
                  f"{sync.exchange_bytes(sync.prepare(perm, n), row, bf16)}"
                  f" sync; re-layout bytes "
                  f"{coll.relayout_bytes(prep, row, bf16)}")
            turns = {"sync": [], "double_buffered": []}
            for _ in range(2):
                for pipe in turns:
                    turns[pipe].append(timed_epoch(lambda: sharded_epoch(
                        run, group, 2, None, alpha=alpha,
                        collector_pipeline=pipe,
                        collector_submesh=submesh if pipe != "sync"
                        else None)))
            print(f"  {name}: warm ms/step in turns, " + "; ".join(
                f"{pipe} " + ", ".join(f"{t / steps * 1e3:.1f}" for t in v)
                for pipe, v in turns.items()) + f" ({smi})")
    finally:
        torch.backends.cudnn.deterministic = False
        ED.close_data_group()
    return launches


def launcher_entry_points(smi):
    phase("19. entry points: python -m repro_torch.launch.eval --paper "
          "--sharded --pipeline double_buffered, and python -m "
          "repro_torch.launch.train --paper --sharded --scheme sflv2 (world "
          "size 1, NCCL)")
    print(f"card: {smi} (every time below was taken on it)")
    env = dict(os.environ, PYTHONPATH=str(HERE / "src"))
    runs = [(["repro_torch.launch.eval", "--paper", "--sharded",
              "--pipeline", "double_buffered"],
             ["matched fleet (8 clients, sharded=True", "  sfpl ",
              "  sflv2 "]),
            (["repro_torch.launch.train", "--paper", "--sharded",
              "--scheme", "sflv2"],
             ["sharded SFLv2: 1 rank(s)", "non-IID accuracy",
              "first loss"])]
    for args, lines in runs:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m"] + args, cwd=HERE,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        print(f"$ python -m {' '.join(args)}  "
              f"({time.perf_counter() - t0:.1f} s on {smi})")
        print(res.stdout.strip())
        if res.returncode != 0:
            raise AssertionError(f"{args[0]} exited {res.returncode}:\n"
                                 f"{res.stderr[-4000:]}")
        missing = [line for line in lines if line not in res.stdout]
        if missing:
            raise AssertionError(f"{args[0]} printed no {missing}")


# --------------------------------------------------------------------------
# phases 20-22: fault-tolerant SFPL, LM training, their entry points

FAULTS = dict(drop_rate=0.2, straggler_rate=0.1, straggler_delay=0.05,
              straggler_timeout=0.02)


def fault_tolerant_training(smi):
    phase("20. fault-tolerant SFPL: train_paper, ResNet-56 width 16, 100 "
          "clients x batch 8, 32x32, bf16, drop 0.2, stragglers 0.1 (0.05 s "
          "against a 0.02 s timeout), cuDNN deterministic: 3 epochs "
          "uninterrupted against 2 + a resume for the third; one sharded "
          "masked epoch (world size 1, NCCL)")
    print(f"card: {smi} (every time below was taken on it)")
    import tempfile
    from repro_torch.core import engine_dist as ED
    from repro_torch.core import round as RD
    from repro_torch.core.faults import FaultPlan, ensure_group_survivor
    from repro_torch.launch.train import train_paper
    plan = FaultPlan(CLIENTS, drop_rate=FAULTS["drop_rate"],
                     straggler_rate=FAULTS["straggler_rate"],
                     straggler_delay=FAULTS["straggler_delay"])
    expected = []
    for ep in range(3):
        mask, wait = plan.participation(
            ep, straggler_timeout=FAULTS["straggler_timeout"])
        mask, revived = ensure_group_survivor(mask, CLIENTS)
        expected.append(mask)
        print(f"  epoch {ep}: {int(mask.sum())}/{CLIENTS} clients, dropped "
              f"{np.flatnonzero(~mask).tolist()}, revived {revived}, "
              f"straggler wait {wait:.2f} s")

    # each sfpl_round call of train_paper: its mask and its launches
    rounds, inner = [], RD.sfpl_round

    def counted(*args, **kw):
        K.reset_launches()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        rounds.append((kw["participation"], dict(K.LAUNCHES)))
        return out

    kw = dict(depth=56, width=WIDTH, hw=HW, num_clients=CLIENTS,
              batch_size=BATCH, compute_dtype="bfloat16", **FAULTS)
    torch.backends.cudnn.deterministic = True
    RD.sfpl_round = counted
    try:
        with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
            a, b = f"{tmp}/a.npz", f"{tmp}/b.npz"
            walls = []
            for call in (lambda: train_paper(epochs=3, ckpt=a, ckpt_every=1,
                                             **kw),
                         lambda: train_paper(epochs=2, ckpt=b, ckpt_every=1,
                                             **kw),
                         lambda: train_paper(epochs=3, resume=b, ckpt=b,
                                             **kw)):
                t0 = time.perf_counter()
                walls.append((call(), time.perf_counter() - t0))
    finally:
        RD.sfpl_round = inner
        torch.backends.cudnn.deterministic = False
    (l_a, w_a), (l_b, w_b), (l_r, w_r) = walls
    print(f"run A, 3 epochs: losses {l_a} ({w_a:.1f} s with set-up and "
          f"evaluation); run B, 2 epochs: {l_b} ({w_b:.1f} s); B resumed "
          f"for the third: {l_r} ({w_r:.1f} s)")
    epochs = [0, 1, 2, 0, 1, 2]
    for (mask, launches), ep in zip(rounds, epochs):
        print(f"  epoch {ep}: {int(mask.sum())} clients in the round; "
              f"launches " + ", ".join(f"{k} {launches[k]}"
                                       for k in SINGLE_DEVICE))
    if len(rounds) != len(epochs):
        raise AssertionError(f"{len(rounds)} rounds ran, not {len(epochs)}")
    for (mask, launches), ep in zip(rounds, epochs):
        if not np.array_equal(mask.cpu().numpy(), expected[ep]):
            raise AssertionError(f"epoch {ep}: the round's mask is not the "
                                 f"plan's")
        missing = [k for k in SINGLE_DEVICE if launches[k] <= 0]
        if missing:
            raise AssertionError(f"epoch {ep}: the round launched no "
                                 f"{missing}")
    if not all(math.isfinite(v) for v in l_a + l_b + l_r):
        raise AssertionError("non-finite loss")
    if l_b != l_a[:2] or l_r != l_a[2:]:
        raise AssertionError(f"the resumed run differs from the "
                             f"uninterrupted one: {l_b} + {l_r} != {l_a}")
    print(f"resumed epoch-3 loss {l_r[0]!r} equals the uninterrupted run's "
          f"{l_a[2]!r} exactly")

    run = build_run(56, CLIENTS, HW)
    group = ED.init_data_group(DEV)
    try:
        K.reset_launches()
        _, losses = sharded_epoch(run, group, 1, None,
                                  participation=torch.from_numpy(expected[0]))
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
    finally:
        ED.close_data_group()
    losses = losses.float().cpu()
    print(f"sharded masked epoch (epoch 0's mask): losses {losses.tolist()}; "
          f"launches " + ", ".join(f"{k} {v}" for k, v in launches.items()
                                   if v))
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError(f"non-finite sharded losses {losses.tolist()}")
    missing = [k for k in ("bucket_permute", "unbucket_permute")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the sharded masked epoch launched no "
                             f"{missing}")


def lm_training(smi):
    phase("21. LM training at full width, f32, TF32 off, AdamW on one fixed "
          "batch: qwen3-8b (2 layers, B 2 x S 256, 8 steps) with the loss "
          "checks, and xlstm-1.3b (1 group: 7 mLSTM + 1 sLSTM, B 2 x S 128, "
          "4 steps)")
    print(f"card: {smi} (every time below was taken on it)")
    free_device_memory("phases 1-20")
    from repro_torch.core.split_lm import make_collector_perm, sfpl_lm_loss
    from repro_torch.data.tokens import synthetic_token_stream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.common import (chunked_lm_loss,
                                           softmax_cross_entropy)
    from repro_torch.optim import adamw
    from repro_torch.tree import grads, with_grad
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, layers, b, s, steps in (("qwen3-8b", 2, 2, 256, 8),
                                      ("xlstm-1.3b", 8, 2, 128, 4)):
        spec = get_arch(arch)
        model = spec.model
        cfg = spec.make_config(num_layers=layers, compute_dtype="float32")
        params = lm_init(cfg, seed=5, arch=arch)
        gen = torch.Generator(device=DEV).manual_seed(6)
        toks, labels = synthetic_token_stream(gen, batch=b, seq_len=s,
                                              vocab=cfg.vocab_size)
        batch = {"tokens": toks, "labels": labels}
        if arch == "qwen3-8b":
            with torch.no_grad():
                hidden, _ = model.forward(params, batch, cfg,
                                          return_hidden=True)
                plain = softmax_cross_entropy(
                    model.unembed(params, hidden, cfg), labels)
                chunked = chunked_lm_loss(
                    hidden, labels, lambda xc: model.unembed(params, xc, cfg))
                full, _ = model.loss_fn(params, batch, cfg)
                ident, _ = sfpl_lm_loss(model, params, batch, cfg,
                                        perm=torch.arange(b, device=DEV))
            rel = abs(float(chunked) - float(plain)) / abs(float(plain))
            d_id = abs(float(ident) - float(full))
            print(f"step-0 loss: chunked_lm_loss {float(chunked)!r}, "
                  f"softmax_cross_entropy of the full logits "
                  f"{float(plain)!r} (rel diff {rel:.2e}, tol 1e-5); "
                  f"sfpl_lm_loss, identity perm {float(ident)!r} against "
                  f"loss_fn {float(full)!r} (|diff| {d_id:.2e}, tol 1e-6 of "
                  f"the loss)")
            if rel > 1e-5 or d_id > 1e-6 * abs(float(full)):
                raise AssertionError("the LM losses disagree")
            del hidden
            p = with_grad(params)
            loss, _ = sfpl_lm_loss(model, p, batch, cfg,
                                   perm=make_collector_perm(gen, b))
            g = grads(loss, p)
            bad = [i for i, t in enumerate(tree_leaves(g))
                   if not bool(torch.isfinite(t).all())]
            print(f"sfpl_lm_loss with a random perm: loss {loss.item():.4f}, "
                  f"{len(tree_leaves(g))} gradient leaves, non-finite: {bad}")
            if bad or not math.isfinite(loss.item()):
                raise AssertionError("sfpl_lm_loss gave non-finite grads")
            del p, g, loss
        opt = adamw(1e-3)
        opt_state = opt.init(params)
        step_fn = make_train_step(spec, cfg, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for i in range(steps):
            t0 = time.perf_counter()
            params, opt_state, _, loss = step_fn(params, opt_state, i, batch)
            losses.append(float(loss))      # synchronises
            ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{arch} ({layers} blocks/layers) train steps: losses "
              f"{[round(v, 4) for v in losses]}; ms/step "
              f"{[round(v, 1) for v in ms]} (the first with allocator "
              f"warm-up); peak memory {peak:.2f} GiB ({smi})")
        if not all(math.isfinite(v) for v in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"{arch}: the loss did not fall: {losses}")
        # one more step under the profiler (its result is dropped)
        profile_steps(lambda _: step_fn(params, opt_state, steps, batch),
                      steps=1, what=f"{arch} train steps")
        del params, opt_state, step_fn
        torch.cuda.empty_cache()


def _run_entry(args, env, smi):
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m"] + args, cwd=HERE, env=env,
                         capture_output=True, text=True, timeout=300)
    print(f"$ python -m {' '.join(args)}  ({time.perf_counter() - t0:.1f} s "
          f"on {smi})")
    print(res.stdout.strip())
    if res.returncode != 0:
        raise AssertionError(f"{args[0]} exited {res.returncode}:\n"
                             f"{res.stderr[-4000:]}")
    return res.stdout


def _floats(pattern, text):
    found = [float(v) for v in re.findall(pattern, text)]
    if not found or not all(math.isfinite(v) for v in found):
        raise AssertionError(f"no finite value for {pattern!r} in:\n{text}")
    return found


def training_entry_points(smi):
    phase("22. entry points: python -m repro_torch.launch.train --paper "
          "with faults, --ckpt and --resume; --arch qwen3-8b --ckpt; python "
          "-m repro_torch.launch.eval --arch qwen3-8b --ckpt")
    print(f"card: {smi} (every time below was taken on it)")
    import tempfile
    from repro_torch.launch.eval import evaluate_lm
    env = dict(os.environ, PYTHONPATH=str(HERE / "src"))
    with tempfile.TemporaryDirectory(dir=HERE / "build") as tmp:
        state, lm = f"{tmp}/state.npz", f"{tmp}/lm.npz"
        paper = ["repro_torch.launch.train", "--paper", "--compute-dtype",
                 "bfloat16", "--drop-rate", "0.2", "--ckpt", state]
        out = _run_entry(paper + ["--ckpt-every", "1", "--epochs", "2"],
                         env, smi)
        first = _floats(r"epoch +\d+ loss ([-\d.e]+)", out)
        acc = _floats(r"non-IID accuracy ([\d.]+)%", out)
        if len(first) != 2 or "participation" not in out:
            raise AssertionError("the fault-tolerant run printed no masks or "
                                 "not 2 epochs")
        out = _run_entry(paper + ["--resume", state, "--epochs", "3"], env,
                         smi)
        resumed = _floats(r"epoch +\d+ loss ([-\d.e]+)", out)
        acc += _floats(r"non-IID accuracy ([\d.]+)%", out)
        if "resumed from" not in out or len(resumed) != 1:
            raise AssertionError("the resumed run did not resume at epoch 2")
        print(f"paper losses {first} + resumed {resumed}; non-IID accuracy "
              f"{acc} %")
        out = _run_entry(["repro_torch.launch.train", "--arch", "qwen3-8b",
                          "--steps", "20", "--ckpt", lm], env, smi)
        lm_first = _floats(r"first loss ([-\d.e]+) ->", out)[0]
        lm_last = _floats(r"-> last loss ([-\d.e]+)", out)[0]
        out = _run_entry(["repro_torch.launch.eval", "--arch", "qwen3-8b",
                          "--ckpt", lm], env, smi)
    trained = _floats(r"qwen3-8b: loss ([-\d.e]+)", out)[0]
    ppl = _floats(r"ppl ([\d.]+)", out)[0]
    tok_acc = _floats(r"token-acc ([\d.]+)", out)[0]
    spec = get_arch("qwen3-8b")
    cfg = spec.make_smoke_config()
    p0 = spec.model.init(torch.Generator(device=DEV).manual_seed(0), cfg)
    before = evaluate_lm(spec, cfg, p0)
    print(f"qwen3-8b smoke: training loss {lm_first} -> {lm_last}; eval of "
          f"the checkpoint: loss {trained}, ppl {ppl}, token accuracy "
          f"{tok_acc}; the untrained init of the same seed: loss "
          f"{before['loss']:.4f}, token accuracy "
          f"{before['token_accuracy']:.3f}")
    if not trained < before["loss"]:
        raise AssertionError(f"the trained checkpoint ({trained}) does not "
                             f"beat the untrained init ({before['loss']})")


def main():
    smi = device_and_build()
    measured = kernels_vs_plain()
    launches = main_path()
    entry_point()
    card_vs_cpu()
    launches_sharded = sharded_path()
    sharded_entry_point()
    launches_lm = lm_prefill()
    lm_checks()
    lm_serving()
    launches_x = xlstm_prefill()
    xlstm_checks()
    xlstm_serving()
    launches_g = gemma_prefill()
    gemma_checks()
    gemma_serving()
    paper_comparison(smi)
    streamed_path(smi)
    launcher_entry_points(smi)
    fault_tolerant_training(smi)
    lm_training(smi)
    training_entry_points(smi)
    phase("done")
    path = {name: "phase 3 (single-device SFPL epoch)"
            for name in SINGLE_DEVICE}
    for name in ("bucket_permute", "unbucket_permute", "quant_bucket_permute",
                 "dequant_unbucket_permute"):
        launches[name] = launches_sharded[name]
        path[name] = "phase 6 (sharded SFPL epoch)"
    launches["flash_attention"] = launches_lm["flash_attention"]
    path["flash_attention"] = "phase 8 (one qwen3-8b prefill)"
    launches["rmsnorm"] = launches_lm["rmsnorm"]
    path["rmsnorm"] = "phase 8b (rmsnorm_apply(use_kernel=True))"
    launches["slstm_scan"] = launches_x["slstm_scan"]
    path["slstm_scan"] = "phase 11 (one xlstm-1.3b prefill)"
    launches["flash_attention_d256"] = launches_g["flash_attention"]
    path["flash_attention_d256"] = "phase 14 (one gemma-7b prefill)"
    lines = []
    for name, row in measured.items():
        route, source = ROUTE[name]
        lines.append(dict(
            name=name, route=route, source=source, replaces=REPLACES[name],
            launches=launches[name], path=path[name],
            max_abs_err=row["max_abs_err"],
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
