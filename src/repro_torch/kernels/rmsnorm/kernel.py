"""Triton kernel for the fused RMSNorm (K6).

Replaces ``src/repro/kernels/rmsnorm/kernel.py::rmsnorm_2d`` (Pallas,
TPU), which pads the feature axis to 128 lanes and the rows to the block,
then sweeps (256, Dp) row blocks through VMEM.

Bound on Hopper: bytes. One read of ``x`` and one write of ``y``
(``2 * R * d * itemsize``), plus the ``(d,)`` scale once; about four
operations per element, far under the tensor-free f32 rate. At qwen3-8b's
shapes (16384 x 4096 and 524288 x 128 bf16, 134 MB each way) that is about
40 us at 3.35 TB/s.

Design: one program per block of rows, the whole feature axis of each row
in registers (``BLOCK_D`` the next power of two of ``d``, columns past
``d`` masked on load and store, so the widths 100 and 300 need no padded
copy and the mean divides by the real ``d``). Rows per program are chosen
so a program holds about 8192 elements: 2 rows of 4096, 64 rows of 128, so
every load is a long coalesced run and a launch has thousands of
programs for the card's 132 SMs. Math is in f32 (``x * rsqrt(ms + eps) *
(scale + offset)``), stored in ``x``'s dtype. Triton is imported and the
kernel compiled inside the launching function only.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/rmsnorm/kernel.py"
MAX_D = 65536
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@functools.cache
def _kernel():
    triton = build.import_triton()
    import triton.language as tl

    @triton.jit
    def rmsnorm_kernel(x_ptr, s_ptr, y_ptr, R, D, stride_x, stride_y, eps,
                       offset, BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < D
        mask = (rows < R)[:, None] & cmask[None, :]
        x = tl.load(x_ptr + rows[:, None].to(tl.int64) * stride_x
                    + cols[None, :], mask=mask, other=0.0).to(tl.float32)
        ms = tl.sum(x * x, axis=1) / D
        s = tl.load(s_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        y = x * tl.rsqrt(ms + eps)[:, None] * (s + offset)[None, :]
        tl.store(y_ptr + rows[:, None].to(tl.int64) * stride_y
                 + cols[None, :], y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, rmsnorm_kernel


def _blocks(d):
    block_d = 1 << max(0, (d - 1).bit_length())
    block_r = max(1, min(64, 8192 // block_d))
    num_warps = 8 if block_d >= 2048 else 4
    return block_r, block_d, num_warps


def rmsnorm(x, scale, *, eps=1e-6, scale_offset=0.0):
    """x: (R, d) on the card with unit column stride; scale: (d,) on the
    same device. Returns ``y`` (R, d) contiguous in ``x.dtype``."""
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError("rmsnorm kernel: x and scale must be on one CUDA "
                         "device")
    if x.dtype not in DTYPES:
        raise TypeError(f"rmsnorm kernel takes {DTYPES}, got {x.dtype}")
    if x.dim() != 2 or x.stride(1) != 1 or not 0 < x.shape[1] <= MAX_D:
        raise ValueError(f"rmsnorm kernel: x (R, d) with unit column stride "
                         f"and d <= {MAX_D}; got {tuple(x.shape)} strides "
                         f"{x.stride()}")
    if scale.shape != (x.shape[1],) or not scale.is_contiguous():
        raise ValueError(f"rmsnorm kernel: scale must be contiguous "
                         f"({x.shape[1]},), got {tuple(scale.shape)}")
    triton, kern = _kernel()
    r, d = x.shape
    y = torch.empty((r, d), dtype=x.dtype, device=x.device)
    if r == 0:
        return y
    block_r, block_d, num_warps = _blocks(d)
    kern[(triton.cdiv(r, block_r),)](x, scale, y, r, d, x.stride(0),
                                     y.stride(0), float(eps),
                                     float(scale_offset), BLOCK_R=block_r,
                                     BLOCK_D=block_d, num_warps=num_warps)
    LAUNCHES["rmsnorm"] += 1
    return y
