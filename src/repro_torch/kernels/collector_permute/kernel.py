"""Launch the CUDA row-gather kernels (``csrc/collector_permute.cu``).

``collector_permute`` (K1), ``bucket_permute`` (K4a) and
``unbucket_permute`` (K4b) replace ``collector_permute_2d``,
``bucket_permute_2d`` and ``unbucket_permute_2d`` of
``src/repro/kernels/collector_permute/kernel.py``. Each is bound by the
bytes it copies (``2 * rows * row_bytes``); the source file says how its
design meets that.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES, count
from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/collector_permute.cu"


@functools.cache
def _fn():
    fn = build.library("collector_permute").sfpl_collector_permute
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _plan_fn(name):
    fn = getattr(build.library("collector_permute"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_bytes(rows, row_bytes, index_bytes):
    """Bytes one K1 launch moves: ``rows`` rows of ``row_bytes`` read and
    written, and one index of ``index_bytes`` read for each."""
    return rows * (2 * row_bytes + index_bytes)


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
    count("collector_permute", gather_bytes(rows, row_bytes,
                                            perm.element_size()))
    return out


def _check_rows(name, x, idx):
    if not (x.is_cuda and idx.is_cuda and x.device == idx.device):
        raise ValueError(f"{name} kernel: x and idx must be on the same "
                         f"CUDA device")
    if not x.is_floating_point():
        raise TypeError(f"{name} kernel takes float rows, got {x.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name} kernel takes int32 or int64 indices, got "
                        f"{idx.dtype}")
    if not (x.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{name} kernel needs contiguous inputs")


def _gather(name, symbol, x, idx, out_rows):
    _check_rows(name, x, idx)
    out = torch.empty((out_rows,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    row_bytes = (x.numel() // max(x.shape[0], 1)) * x.element_size()
    err = _plan_fn(symbol)(
        x.data_ptr(), idx.data_ptr(), out.data_ptr(), out_rows, row_bytes,
        int(idx.dtype == torch.int64),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, name)
    return out


def bucket_permute(x, idx):
    """K4a. x: (R, ...) contiguous float CUDA rows; idx: (S, cap) int32 or
    int64 on the same device, each entry a row of x. Returns the
    (S*cap, ...) send buffer ``out[s*cap + r] = x[idx[s, r]]``."""
    if idx.dim() != 2:
        raise ValueError(f"bucket_permute idx must be (S, cap), got "
                         f"{tuple(idx.shape)}")
    out = _gather("bucket_permute", "sfpl_bucket_permute", x, idx,
                  idx.numel())
    LAUNCHES["bucket_permute"] += 1
    return out


def unbucket_permute(x, idx):
    """K4b. x: (R, ...) contiguous float CUDA rows (the flat received
    block); idx: (B,) int32 or int64, each entry a row of x. Returns
    ``out[i] = x[idx[i]]``, (B, ...)."""
    if idx.dim() != 1:
        raise ValueError(f"unbucket_permute idx must be (B,), got "
                         f"{tuple(idx.shape)}")
    out = _gather("unbucket_permute", "sfpl_unbucket_permute", x, idx,
                  idx.shape[0])
    LAUNCHES["unbucket_permute"] += 1
    return out
