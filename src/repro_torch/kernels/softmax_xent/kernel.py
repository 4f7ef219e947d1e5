"""Triton kernels for the fused softmax cross-entropy, forward and backward.

Replace ``src/repro/kernels/softmax_xent/kernel.py::xent_fwd_2d`` and
``::xent_bwd_2d`` (Pallas, TPU), which pad the class axis to 128 lanes and
sweep (256, Vp) row blocks.

Bound on Hopper: at the main path's shape (800 rows x 100 classes) both
sweeps move well under a megabyte, so launch latency and the length of
the dependent chain in one program, not bandwidth or arithmetic, bound
them; the byte bound is one read of the logits and one write of the
per-row results (forward) or of ``dx`` (backward).

Design: the whole class axis of each row in registers (``BLOCK_V`` the
next power of two, columns past ``V`` masked to ``-inf`` on load, so V =
100 needs no padded copy). The forward spreads the rows over many small
programs: 4 rows of up to 128 classes in one warp (200 programs at 800
rows, 16 values a thread), one row in 1-8 warps for wider rows. Each
program reduces the max and the sum of ``exp2((x - m) * log2 e)`` in f32,
takes ``lse = m + log2(sum) * ln 2``, and fetches the label logit with one
scalar load, not a second masked reduction; it writes ``nll`` and
``lse``. The backward keeps its 64-row blocks: it rebuilds the softmax
from the saved ``lse`` (no second reduction), subtracts the one-hot,
scales by the per-row ``g`` and stores in the logits' dtype.

Rows wider than ``MAX_V`` classes (an LM vocabulary, where the Pallas
kernel pads V and takes any width) do not fit one block: the forward
takes one row a program and loops over blocks of ``WIDE_V`` columns with
a running max and sum (``xent_fwd_wide_kernel``); the backward spreads
the columns over a second grid axis, each program rebuilding its block
from the saved ``lse``. Row offsets are formed in int64 in both
directions, so R x V past 2**31 elements addresses right.

Both stay in Triton: they are row reductions, which Triton expresses in
a few lines with the same warp-shuffle reductions a CUDA C++ version
would write by hand. Triton is imported and the kernels are compiled
inside the launching functions only.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/softmax_xent/kernel.py"
MAX_V = 16384          # the widest row one program holds whole
WIDE_V = 4096          # the column block of rows wider than MAX_V
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

    return triton, xent_fwd_kernel, xent_bwd_kernel, xent_fwd_wide_kernel


def _blocks(v):
    """The backward's (rows, classes) block: up to 4096 values, or the
    whole row up to ``MAX_V`` classes; ``WIDE_V`` columns of one row past
    that."""
    if v > MAX_V:
        return 1, WIDE_V
    block_v = 1 << max(0, (v - 1).bit_length())
    block_r = max(1, min(64, 4096 // block_v))
    return block_r, block_v


def _fwd_blocks(v):
    """The forward's (rows, classes, warps): 16 values a thread up to 512
    values a program (4 rows of up to 128 classes in one warp), then one
    row a program in up to 8 warps."""
    block_v = 1 << max(0, (v - 1).bit_length())
    block_r = max(1, min(4, 512 // block_v))
    return block_r, block_v, max(1, min(8, block_r * block_v // 512))


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


def xent_fwd(x, labels):
    """x: (R, V) logits on the card; labels: (R,) int64 valid class ids.
    Returns per-row ``(nll, lse)``, both (R,) float32."""
    _check(x, labels)
    triton, fwd, _, fwd_wide = _kernels()
    r, v = x.shape
    nll = torch.empty(r, dtype=torch.float32, device=x.device)
    lse = torch.empty_like(nll)
    if v > MAX_V:
        fwd_wide[(r,)](x, labels, nll, lse, v, x.stride(0), BLOCK_V=WIDE_V,
                       num_warps=8)
    else:
        block_r, block_v, warps = _fwd_blocks(v)
        fwd[(triton.cdiv(r, block_r),)](x, labels, nll, lse, r, v,
                                        x.stride(0), BLOCK_R=block_r,
                                        BLOCK_V=block_v, num_warps=warps)
    LAUNCHES["xent_fwd"] += 1
    return nll, lse


def xent_bwd(x, labels, lse, g):
    """``(softmax(x) - onehot) * g`` per row in ``x.dtype``; lse, g: (R,)
    float32."""
    _check(x, labels, lse, g)
    triton, _, bwd, _ = _kernels()
    r, v = x.shape
    dx = torch.empty((r, v), dtype=x.dtype, device=x.device)
    block_r, block_v = _blocks(v)
    bwd[(triton.cdiv(r, block_r), triton.cdiv(v, block_v))](
        x, labels, lse, g, dx, r, v, x.stride(0), dx.stride(0),
        BLOCK_R=block_r, BLOCK_V=block_v, num_warps=4)
    LAUNCHES["xent_bwd"] += 1
    return dx
