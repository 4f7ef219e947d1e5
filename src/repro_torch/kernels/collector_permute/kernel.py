"""Launch the CUDA row-gather kernel (``csrc/collector_permute.cu``).

Replaces ``src/repro/kernels/collector_permute/kernel.py::
collector_permute_2d``. The kernel is bound by the bytes it copies
(``2 * R * D * itemsize``); the source file says how its design meets that.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/collector_permute.cu"


@functools.cache
def _fn():
    fn = build.library("collector_permute").sfpl_collector_permute
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def collector_permute(x, perm):
    """x: (R, ...) contiguous float CUDA tensor; perm: (R,) int64 on the
    same device, a permutation of ``range(R)``. Returns ``x[perm]``."""
    if not (x.is_cuda and perm.is_cuda and x.device == perm.device):
        raise ValueError("collector_permute kernel: x and perm must be on "
                         "the same CUDA device")
    if not x.is_floating_point():
        raise TypeError(f"collector_permute kernel takes float rows, got "
                        f"{x.dtype}")
    if perm.dtype != torch.int64 or perm.shape != (x.shape[0],):
        raise ValueError(f"perm must be int64 of shape ({x.shape[0]},), got "
                         f"{perm.dtype} {tuple(perm.shape)}")
    if not (x.is_contiguous() and perm.is_contiguous()):
        raise ValueError("collector_permute kernel needs contiguous inputs")
    out = torch.empty_like(x)
    rows = x.shape[0]
    row_bytes = (x.numel() // max(rows, 1)) * x.element_size()
    err = _fn()(x.data_ptr(), perm.data_ptr(), out.data_ptr(), rows,
                row_bytes, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "collector_permute")
    LAUNCHES["collector_permute"] += 1
    return out
