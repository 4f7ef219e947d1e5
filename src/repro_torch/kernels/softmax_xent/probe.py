"""K3b (``kernel.xent_bwd``) beside the designs it was measured against, on
the same inputs on one card.

    PYTHONPATH=src python -m repro_torch.kernels.softmax_xent.probe

Two measurement-only designs, compiled here and launched nowhere else:

- ``blocks``: the backward that ``kernel.xent_bwd`` replaced: up to 4,096
  values in blocks of up to 64 rows (32 at 100 classes) of 4 warps, with
  the offsets of every element formed in int64; past ``MAX_V`` classes a
  column grid axis of 4,096-column blocks.
- ``row_loop`` (V > ``MAX_V`` only): one row a program in 8 warps that
  loops over its ``WIDE_V``-column blocks, instead of the kernel's column
  grid axis of ``WIDE_BWD_V`` blocks.

Each shape of ``SHAPES`` gets inputs from a seed; every design is held
against ``ref.xent_bwd`` (1 ulp of a 16-bit type, 1e-5 relative in f32)
and timed in turns (``blocks``, kernel, [``row_loop`` twice], kernel,
``blocks``): a CUDA graph of 20 calls, replayed 5 times a turn, each
replay between CUDA events. ``compare()`` returns one row a shape with
the fastest and the median replay of each design in microseconds a call.
``sweep()`` times the kernels' own bodies at the other blockings that
``kernel.geometry`` was chosen from (``BLOCKINGS``), in turns, twice.
``main()`` prints both as JSON lines, then the card's name and power
limit. Needs one card.
"""
from __future__ import annotations

import functools
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import build
from repro_torch.kernels.softmax_xent import kernel as xent_k
from repro_torch.kernels.softmax_xent import ref as xent_ref

# (rows, classes, dtype): the main path's pool, K3f's one-program edge, a
# 1,000-class row, a GPT-2-sized vocabulary, and a ragged small case
SHAPES = ((800, 100, torch.bfloat16), (33, 100, torch.bfloat16),
          (1000, 1000, torch.bfloat16), (64, 50257, torch.bfloat16),
          (64, 50257, torch.float32), (37, 13, torch.float32))
# (rows, classes, dtype, direction, [(rows a program, column block, warps)])
_FEW_ROWS = [(1, 128, 1), (2, 128, 1), (2, 128, 2), (4, 128, 1),
             (4, 128, 2)]
_WIDE_BWD = [(1, b, w) for b in (1024, 2048, 4096) for w in (4, 8)]
BLOCKINGS = ((800, 100, torch.bfloat16, "bwd", _FEW_ROWS),
             (800, 100, torch.bfloat16, "fwd", _FEW_ROWS),
             (33, 100, torch.bfloat16, "bwd", _FEW_ROWS),
             (33, 100, torch.bfloat16, "fwd", _FEW_ROWS),
             (64, 50257, torch.bfloat16, "bwd", _WIDE_BWD),
             (64, 50257, torch.float32, "bwd", _WIDE_BWD),
             (64, 50257, torch.bfloat16, "fwd", [(1, 4096, 8), (1, 8192, 8)]))


@functools.cache
def _designs():
    triton = build.import_triton()
    import triton.language as tl

    @triton.jit
    def xent_bwd_blocks(x_ptr, lab_ptr, lse_ptr, g_ptr, dx_ptr, R, V,
                        stride_x, stride_dx, BLOCK_R: tl.constexpr,
                        BLOCK_V: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.program_id(1) * BLOCK_V + tl.arange(0, BLOCK_V)
        rmask = rows < R
        mask = rmask[:, None] & (cols[None, :] < V)
        rows64 = rows.to(tl.int64)
        x = tl.load(x_ptr + rows64[:, None] * stride_x + cols[None, :],
                    mask=mask, other=0.0).to(tl.float32)
        lse = tl.load(lse_ptr + rows, mask=rmask, other=0.0)
        g = tl.load(g_ptr + rows, mask=rmask, other=0.0)
        lab = tl.load(lab_ptr + rows, mask=rmask, other=0)
        p = tl.exp(x - lse[:, None])
        onehot = tl.where(cols[None, :] == lab[:, None], 1.0, 0.0)
        d = (p - onehot) * g[:, None]
        tl.store(dx_ptr + rows64[:, None] * stride_dx + cols[None, :],
                 d.to(dx_ptr.dtype.element_ty), mask=mask)

    @triton.jit
    def xent_bwd_row_loop(x_ptr, lab_ptr, lse_ptr, g_ptr, dx_ptr, V,
                          stride_x, stride_dx, BLOCK_V: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        x_row = x_ptr + row * stride_x
        dx_row = dx_ptr + row * stride_dx
        lse = tl.load(lse_ptr + row)
        g = tl.load(g_ptr + row)
        lab = tl.load(lab_ptr + row).to(tl.int32)
        cols = tl.arange(0, BLOCK_V)
        for v0 in range(0, V, BLOCK_V):
            c = v0 + cols
            x = tl.load(x_row + c, mask=c < V, other=0.0).to(tl.float32)
            p = tl.exp2((x - lse) * 1.4426950408889634)
            d = tl.where(c == lab, p - 1.0, p) * g
            tl.store(dx_row + c, d.to(dx_ptr.dtype.element_ty), mask=c < V)

    def blocks(x, labels, lse, g):
        r, v = x.shape
        if v > xent_k.MAX_V:
            block_r, block_v = 1, 4096
        else:
            block_v = 1 << max(0, (v - 1).bit_length())
            block_r = max(1, min(64, 4096 // block_v))
        dx = torch.empty_like(x)
        xent_bwd_blocks[(triton.cdiv(r, block_r), triton.cdiv(v, block_v))](
            x, labels, lse, g, dx, r, v, x.stride(0), dx.stride(0),
            BLOCK_R=block_r, BLOCK_V=block_v, num_warps=4)
        return dx

    def row_loop(x, labels, lse, g):
        dx = torch.empty_like(x)
        xent_bwd_row_loop[(x.shape[0],)](
            x, labels, lse, g, dx, x.shape[1], x.stride(0), dx.stride(0),
            BLOCK_V=xent_k.WIDE_V, num_warps=8)
        return dx

    return blocks, row_loop


def replays_us(fn, calls=20, reps=5):
    """Microseconds a call of each of ``reps`` replays of a CUDA graph of
    ``calls`` calls, after 3 warm calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    out = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) * 1e3 / calls)
    return out


def _within(got, want, dtype):
    rel = 1e-5 if dtype == torch.float32 else torch.finfo(dtype).eps
    d = (got.double() - want.double()).abs()
    return float(d.max()), bool((d <= rel * want.double().abs()
                                 + 1e-7).all())


def compare(shapes=SHAPES, seed=0):
    """One row a shape: each design's max error against the plain version
    and its fastest and median replay, in microseconds a call. Raises if a
    design disagrees with the plain version."""
    blocks, row_loop = _designs()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for r, v, dtype in shapes:
        x = (3 * torch.randn(r, v, device=dev, generator=gen)).to(dtype)
        lab = torch.randint(0, v, (r,), device=dev, generator=gen)
        g = torch.rand(r, device=dev, generator=gen) / r
        _, lse = xent_ref.xent_fwd(x, lab)
        designs = {"blocks": blocks, "kernel": xent_k.xent_bwd}
        if v > xent_k.MAX_V:
            designs["row_loop"] = row_loop
        want = xent_ref.xent_bwd(x, lab, lse, g)
        row = dict(rows=r, classes=v, dtype=str(dtype).split(".")[-1])
        for name, fn in designs.items():
            err, ok = _within(fn(x, lab, lse, g), want, dtype)
            if not ok:
                raise AssertionError(f"K3b design {name} at {r} x {v} "
                                     f"{dtype}: max err {err}")
            row[name] = dict(max_abs_err=err, us=[])
        turns = list(designs)
        for name in turns + turns[::-1]:
            fn = designs[name]
            row[name]["us"] += replays_us(lambda: fn(x, lab, lse, g))
        for name in designs:
            us = row[name].pop("us")
            row[name].update(us_min=min(us), us_median=statistics.median(us))
        out.append(row)
    return out


def _launch(direction, x, lab, lse, g, rows, block_v, warps):
    """One launch of the kernel module's own forward or backward body at a
    blocking of the caller's choosing (not counted in ``LAUNCHES``)."""
    fwd, bwd, fwd_wide = xent_k._kernels()
    r, v = x.shape
    if direction == "bwd":
        dx = torch.empty_like(x)
        bwd[(-(-r // rows), -(-v // block_v))](
            x, lab, lse, g, dx, r, v, x.stride(0), dx.stride(0),
            BLOCK_R=rows, BLOCK_V=block_v, num_warps=warps)
        return dx
    nll, lse_out = (torch.empty(r, device=x.device) for _ in range(2))
    if v > xent_k.MAX_V:
        fwd_wide[(r,)](x, lab, nll, lse_out, v, x.stride(0),
                       BLOCK_V=block_v, num_warps=warps)
    else:
        fwd[(-(-r // rows),)](x, lab, nll, lse_out, r, v, x.stride(0),
                              BLOCK_R=rows, BLOCK_V=block_v, num_warps=warps)
    return lse_out


def sweep(blockings=BLOCKINGS, seed=0):
    """One row a (shape, direction): the fastest replay of each blocking
    in microseconds a call, over two rounds of turns, each blocking held
    against the plain version first."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for r, v, dtype, direction, variants in blockings:
        x = (3 * torch.randn(r, v, device=dev, generator=gen)).to(dtype)
        lab = torch.randint(0, v, (r,), device=dev, generator=gen)
        g = torch.rand(r, device=dev, generator=gen) / r
        _, lse = xent_ref.xent_fwd(x, lab)
        want = xent_ref.xent_bwd(x, lab, lse, g)
        fns = {f"r{a}b{b}w{w}": functools.partial(_launch, direction, x,
                                                  lab, lse, g, a, b, w)
               for a, b, w in variants}
        for name, fn in fns.items():
            got = fn()
            ok = (_within(got, want, dtype)[1] if direction == "bwd" else
                  bool(torch.allclose(got, lse, rtol=1e-5, atol=1e-5)))
            if not ok:
                raise AssertionError(f"K3 {direction} {name} at {r} x {v} "
                                     f"{dtype} disagrees with the plain "
                                     f"version")
        us = {name: [] for name in fns}
        for _ in range(2):
            for name in list(fns) + list(fns)[::-1]:
                us[name] += replays_us(fns[name])
        out.append(dict(rows=r, classes=v, dtype=str(dtype).split(".")[-1],
                        direction=direction,
                        us_min={n: min(u) for n, u in us.items()}))
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA card")
    for row in compare() + sweep():
        print(json.dumps(row), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
