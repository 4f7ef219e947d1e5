"""Launch the CUDA BN affine + ReLU kernel (``csrc/bn_act.cu``).

Replaces ``src/repro/kernels/bn_act/kernel.py::bn_act_2d``. The kernel is
bound by bytes (one read of ``x``, one write of ``y``); the source file
says how its design meets that.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import count
from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/bn_act.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _fn():
    fn = build.library("bn_act").sfpl_bn_act
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bn_act_bytes(elems, elem_bytes, groups, channels):
    """Bytes one launch moves: ``elems`` elements of ``x`` read and of
    ``y`` written, and the f32 affine ``a``, ``b`` (``groups`` x
    ``channels`` each) read."""
    return 2 * elems * elem_bytes + 2 * groups * channels * 4


def bn_act(x, a, b, *, relu=True):
    """x: (G, rows, C) contiguous f32/bf16/f16 CUDA tensor; a, b: (G, C)
    contiguous f32 on the same device. Returns ``relu?(x * a + b)`` in
    ``x.dtype``."""
    if not (x.is_cuda and a.device == x.device and b.device == x.device):
        raise ValueError("bn_act kernel: x, a, b must be on one CUDA device")
    if x.dtype not in DTYPES:
        raise TypeError(f"bn_act kernel takes {list(DTYPES)}, got {x.dtype}")
    if x.dim() != 3 or a.shape != (x.shape[0], x.shape[2]) \
            or b.shape != a.shape:
        raise ValueError(f"bn_act kernel: x (G, rows, C) with a, b (G, C); "
                         f"got {tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("bn_act kernel: a and b must be float32")
    if not (x.is_contiguous() and a.is_contiguous() and b.is_contiguous()):
        raise ValueError("bn_act kernel needs contiguous inputs")
    g, rows, c = x.shape
    y = torch.empty_like(x)
    err = _fn()(x.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(), g,
                rows * c, c, DTYPES[x.dtype], int(relu),
                torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "bn_act")
    count("bn_act", bn_act_bytes(x.numel(), x.element_size(), g, c))
    return y
