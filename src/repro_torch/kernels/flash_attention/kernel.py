"""Launch the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd``.
The kernel is bound by operations (the tensor cores) at the prefill's
shapes; the source file says how its design meets that. It reads q, k and
v in the model's (B, S, heads, D) layout through their strides, so no
transpose or padding copy is made around it.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)


@functools.cache
def _fn():
    fn = build.library("flash_attention").sfpl_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention kernel: q, k, v must be on one "
                         "CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes one dtype of "
                        f"{list(DTYPES)} for q, k, v; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention kernel: q (B, Sq, H, D), k and v "
                         f"(B, Skv, K, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    h, kh, d = q.shape[2], k.shape[2], q.shape[3]
    if h % kh != 0 or d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: H % K == 0 and D in "
                         f"{HEAD_DIMS}; got H {h}, K {kh}, D {d}")
    # bf16 tiles move in 16-byte vectors: rows must start 16-byte aligned
    align = 16 if q.dtype == torch.bfloat16 else 4
    for t in (q, k, v):
        if t.stride(3) != 1 or t.data_ptr() % align or any(
                s * t.element_size() % align for s in t.stride()[:3]):
            raise ValueError(f"flash_attention kernel: unit stride on D and "
                             f"{align}-byte aligned rows needed; got strides "
                             f"{t.stride()}")


def flash_attention(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, Sq, H, D); k/v: (B, Skv, K, D), bf16 or f32 on the card.
    Returns o (B, Sq, H, D) contiguous in q.dtype. Masks by aligned
    positions 0..S-1: causal ``iq >= ik``, ``iq - ik < window``, and the
    sequence edge ``ik < Skv``."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                      for s in t.stride()[:3]))
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b,
                sq, skv, h, kh, d, ctypes.addressof(strides), float(scale),
                int(causal), 0 if window is None else int(window),
                DTYPES[q.dtype],
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
