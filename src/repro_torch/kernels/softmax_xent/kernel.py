"""Triton kernels for the fused softmax cross-entropy, forward and backward.

Replace ``src/repro/kernels/softmax_xent/kernel.py::xent_fwd_2d`` and
``::xent_bwd_2d`` (Pallas, TPU), which pad the class axis to 128 lanes and
sweep (256, Vp) row blocks.

Bound on Hopper: at the main path's shape (800 rows x 100 classes, bf16)
the forward reads 160 KB and the backward reads and writes 320 KB, 0.05
and 0.1 us at the HBM rate. What bounds both is the launch and the
dependent chain inside one program: load the row, reduce (forward) or
rebuild the softmax (backward), store. So the design keeps that chain
short and spreads the rows over more programs than the card has SMs.

Design: one geometry for both directions (``geometry``), the whole class
axis of each row in registers (``BLOCK_V`` the next power of two, columns
past ``V`` masked on load, so V = 100 needs no padded copy): 4 rows of up
to 128 classes in one warp (200 programs at 800 rows, 16 values a
thread), one row in 1-8 warps for wider rows. Each row's base offset is
formed once in int64 and the per-element column offsets stay 32-bit, so R
x V past 2**31 elements addresses right without 64-bit arithmetic per
element. The forward reduces the max and the sum of ``exp2((x - m) *
log2 e)`` in f32, takes ``lse = m + log2(sum) * ln 2``, and fetches the
label logit with one scalar load, not a second masked reduction; it
writes ``nll`` and ``lse``. The backward loads the three row scalars
(``lse``, ``g``, the label) once a row, rebuilds ``p = exp2((x - lse) *
log2 e)`` (no second reduction), subtracts one where the column is the
label, scales by ``g`` and stores in the logits' dtype.

The backward it replaced held up to 4,096 values in blocks of 32 or 64
rows of 4 warps, with 64-bit offsets formed per element: 25 programs of
32 values a thread and 168 registers at 800 x 100, 2.35 us on an H100
80GB HBM3 at 700 W against the forward's 1.89
(``python -m repro_torch.kernels.softmax_xent.probe`` times both on the
same inputs).

Rows wider than ``MAX_V`` classes (an LM vocabulary, where the Pallas
kernel pads V and takes any width) do not fit one program: the forward
takes one row a program and loops over blocks of ``WIDE_V`` columns with
a running max and sum (``xent_fwd_wide_kernel``); the backward spreads
blocks of ``WIDE_BWD_V`` columns over a second grid axis, each program
rebuilding its block from the saved ``lse``. The forward's loop carries
its sums from block to block and wants long blocks; the backward's
blocks are independent and want many programs: at 64 x 50,257 bf16 on an
H100 80GB HBM3 at 700 W, 1,024-column blocks in 8 warps took 5.5 us,
4,096-column blocks 6.4, and one row a program looping over its blocks
9.9 (``probe.py``).

Both stay in Triton: they are row reductions and a fused elementwise
pass, which Triton expresses in a few lines with the same coalesced loads
and warp-shuffle reductions a CUDA C++ version would write by hand.
Triton is imported and the kernels are compiled inside the launching
functions only.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import count
from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/softmax_xent/kernel.py"
MAX_V = 16384          # the widest row one program holds whole
WIDE_V = 4096          # the forward's column block past MAX_V (looped)
WIDE_BWD_V = 1024      # the backward's there (a program each)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@functools.cache
def _kernels():
    triton = build.import_triton()
    import triton.language as tl

    @triton.jit
    def xent_fwd_kernel(x_ptr, lab_ptr, nll_ptr, lse_ptr, R, V, stride_x,
                        BLOCK_R: tl.constexpr, BLOCK_V: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_V)
        rmask = rows < R
        row_ptr = x_ptr + rows.to(tl.int64) * stride_x
        x = tl.load(row_ptr[:, None] + cols[None, :],
                    mask=rmask[:, None] & (cols[None, :] < V),
                    other=float("-inf")).to(tl.float32)
        lab = tl.load(lab_ptr + rows, mask=rmask, other=0)
        ll = tl.load(row_ptr + lab, mask=rmask, other=0.0).to(tl.float32)
        m = tl.where(rmask, tl.max(x, axis=1), 0.0)
        s = tl.sum(tl.exp2((x - m[:, None]) * 1.4426950408889634), axis=1)
        lse = m + tl.log2(s) * 0.6931471805599453
        tl.store(nll_ptr + rows, lse - ll, mask=rmask)
        tl.store(lse_ptr + rows, lse, mask=rmask)

    @triton.jit
    def xent_fwd_wide_kernel(x_ptr, lab_ptr, nll_ptr, lse_ptr, V, stride_x,
                             BLOCK_V: tl.constexpr):
        row = tl.program_id(0)
        row_ptr = x_ptr + row.to(tl.int64) * stride_x
        cols = tl.arange(0, BLOCK_V)
        # V > BLOCK_V: the first block is whole, and starts the running max
        # and sum that the other blocks update
        x = tl.load(row_ptr + cols).to(tl.float32)
        m = tl.max(x, axis=0)
        s = tl.sum(tl.exp2((x - m) * 1.4426950408889634), axis=0)
        for v0 in range(BLOCK_V, V, BLOCK_V):
            x = tl.load(row_ptr + v0 + cols, mask=v0 + cols < V,
                        other=float("-inf")).to(tl.float32)
            m_new = tl.maximum(m, tl.max(x, axis=0))
            s = s * tl.exp2((m - m_new) * 1.4426950408889634) + tl.sum(
                tl.exp2((x - m_new) * 1.4426950408889634), axis=0)
            m = m_new
        lse = m + tl.log2(s) * 0.6931471805599453
        lab = tl.load(lab_ptr + row)
        ll = tl.load(row_ptr + lab).to(tl.float32)
        tl.store(nll_ptr + row, lse - ll)
        tl.store(lse_ptr + row, lse)

    @triton.jit
    def xent_bwd_kernel(x_ptr, lab_ptr, lse_ptr, g_ptr, dx_ptr, R, V,
                        stride_x, stride_dx, BLOCK_R: tl.constexpr,
                        BLOCK_V: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        col0 = tl.program_id(1) * BLOCK_V
        cols = tl.arange(0, BLOCK_V)
        rmask = rows < R
        mask = rmask[:, None] & (cols[None, :] < V - col0)
        # one 64-bit base a row; the per-element offsets stay 32-bit
        rows64 = rows.to(tl.int64)
        x_row = x_ptr + rows64 * stride_x + col0
        dx_row = dx_ptr + rows64 * stride_dx + col0
        lse = tl.load(lse_ptr + rows, mask=rmask, other=0.0)
        g = tl.load(g_ptr + rows, mask=rmask, other=0.0)
        lab = tl.load(lab_ptr + rows, mask=rmask, other=0).to(tl.int32) - col0
        x = tl.load(x_row[:, None] + cols[None, :], mask=mask,
                    other=0.0).to(tl.float32)
        p = tl.exp2((x - lse[:, None]) * 1.4426950408889634)
        d = tl.where(cols[None, :] == lab[:, None], p - 1.0, p) * g[:, None]
        tl.store(dx_row[:, None] + cols[None, :],
                 d.to(dx_ptr.dtype.element_ty), mask=mask)

    return xent_fwd_kernel, xent_bwd_kernel, xent_fwd_wide_kernel


class Geometry(NamedTuple):
    """One program's share of the (R, V) logits, the same in both
    directions up to ``MAX_V`` classes."""
    rows: int        # rows a program (``BLOCK_R``)
    block_v: int     # columns a program holds at once (``BLOCK_V``)
    warps: int
    col_blocks: int  # ``block_v``-column blocks a row spans

    def programs(self, r):
        """Programs along the rows of an R-row tensor."""
        return -(-r // self.rows)


def geometry(v, wide_v=WIDE_V):
    """Both kernels' blocking of V classes: 4 rows of up to 128 classes in
    one warp (16 values a thread at most); one row a program of up to
    ``MAX_V`` classes in 1-8 warps (16 values a thread up to 4,096
    classes, ``block_v / 256`` past that); past ``MAX_V`` one row in 8
    warps over ``wide_v``-column blocks, which the forward loops over
    (``WIDE_V``) and the backward spreads over a second grid axis
    (``WIDE_BWD_V``)."""
    if v > MAX_V:
        return Geometry(1, wide_v, 8, -(-v // wide_v))
    block_v = 1 << max(0, (v - 1).bit_length())
    rows = 4 if block_v <= 128 else 1
    return Geometry(rows, block_v, max(1, min(8, rows * block_v // 512)), 1)


def _check(x, labels, *rows_f32):
    if not (x.is_cuda and labels.device == x.device
            and all(t.device == x.device for t in rows_f32)):
        raise ValueError("softmax_xent kernel: all operands must be on one "
                         "CUDA device")
    if x.dtype not in DTYPES:
        raise TypeError(f"softmax_xent kernel takes {DTYPES}, got {x.dtype}")
    if x.dim() != 2 or x.stride(1) != 1 or not 0 < x.shape[1] < 2 ** 31:
        raise ValueError(f"softmax_xent kernel: logits (R, V) with unit "
                         f"column stride and 0 < V < 2**31; got "
                         f"{tuple(x.shape)} strides {x.stride()}")
    r = x.shape[0]
    if labels.dtype != torch.int64 or labels.shape != (r,) \
            or not labels.is_contiguous():
        raise ValueError("labels must be contiguous int64 of shape (R,)")
    for t in rows_f32:
        if t.dtype != torch.float32 or t.shape != (r,) \
                or not t.is_contiguous():
            raise ValueError("lse and g must be contiguous float32 (R,)")


def xent_fwd_bytes(r, v, elem_bytes):
    """Bytes one K3f launch moves: the (R, V) logits and int64 labels
    read, f32 ``nll`` and ``lse`` written."""
    return r * v * elem_bytes + r * 8 + 2 * r * 4


def xent_bwd_bytes(r, v, elem_bytes):
    """Bytes one K3b launch moves: logits, int64 labels, f32 ``lse`` and
    row scale read, the logits' gradient written."""
    return 2 * r * v * elem_bytes + r * 8 + 2 * r * 4


def xent_fwd(x, labels):
    """x: (R, V) logits on the card; labels: (R,) int64 valid class ids.
    Returns per-row ``(nll, lse)``, both (R,) float32."""
    _check(x, labels)
    fwd, _, fwd_wide = _kernels()
    r, v = x.shape
    nll = torch.empty(r, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(nll)
    geo = geometry(v)
    if geo.col_blocks > 1:
        fwd_wide[(r,)](x, labels, nll, lse, v, x.stride(0),
                       BLOCK_V=geo.block_v, num_warps=geo.warps)
    else:
        fwd[(geo.programs(r),)](x, labels, nll, lse, r, v, x.stride(0),
                                BLOCK_R=geo.rows, BLOCK_V=geo.block_v,
                                num_warps=geo.warps)
    count("xent_fwd", xent_fwd_bytes(r, v, x.element_size()))
    return nll, lse


def xent_bwd(x, labels, lse, g):
    """``(softmax(x) - onehot) * g`` per row in ``x.dtype``; lse, g: (R,)
    float32."""
    _check(x, labels, lse, g)
    _, bwd, _ = _kernels()
    r, v = x.shape
    dx = torch.empty((r, v), dtype=x.dtype, device=x.device)
    geo = geometry(v, WIDE_BWD_V)
    bwd[(geo.programs(r), geo.col_blocks)](
        x, labels, lse, g, dx, r, v, x.stride(0), dx.stride(0),
        BLOCK_R=geo.rows, BLOCK_V=geo.block_v, num_warps=geo.warps)
    count("xent_bwd", xent_bwd_bytes(r, v, x.element_size()))
    return dx
