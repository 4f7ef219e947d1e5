"""Launch the CUDA quantize/dequantize gathers (``csrc/quant_permute.cu``).

``quant_bucket_permute`` (K5a) and ``dequant_unbucket_permute`` (K5b)
replace ``quant_bucket_permute_2d`` and ``dequant_unbucket_permute_2d`` of
``src/repro/kernels/quant_permute/kernel.py``. Both are bound by bytes;
the source file says how the design meets that and how it keeps the
plain version's arithmetic bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import wire as W
from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/quant_permute.cu"
_IN = (torch.float32, torch.bfloat16)
_WIRE = {"int8": torch.int8, "float8_e4m3": torch.float8_e4m3fn}


@functools.cache
def _quant_fn():
    fn = build.library("quant_permute").sfpl_quant_bucket_permute
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _dequant_fn():
    fn = build.library("quant_permute").sfpl_dequant_unbucket_permute
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_idx(name, idx, device):
    if not (idx.is_cuda and idx.device == device):
        raise ValueError(f"{name} kernel: idx must be on {device}")
    if idx.dtype not in (torch.int32, torch.int64) or not \
            idx.is_contiguous():
        raise ValueError(f"{name} kernel takes contiguous int32/int64 "
                         f"indices, got {idx.dtype}")


def quant_bucket_permute(x, idx, wire_dtype, *, packed=False):
    """K5a. x: (R, d) contiguous f32/bf16 CUDA rows; idx: (S, cap) or flat
    (K,) int32/int64 on the same device, each entry a row of x.

    ``packed=False`` returns ``(q, scales)``: q (K, d) in the wire dtype,
    f32 scales (K,). ``packed=True`` returns the collector's one-operand
    wire payload (K, d + SCALE_LANES): q in the first d columns and each
    row's f32 scale bitcast into its last four lanes, written in place."""
    if not x.is_cuda:
        raise ValueError("quant_bucket_permute kernel: x must be on CUDA")
    if x.dtype not in _IN or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"quant_bucket_permute kernel takes contiguous "
                         f"(R, d) f32/bf16 rows, got {x.dtype} "
                         f"{tuple(x.shape)}")
    _check_idx("quant_bucket_permute", idx, x.device)
    rows, d = idx.numel(), x.shape[1]
    wdt = _WIRE[wire_dtype]
    if packed:
        payload = torch.empty((rows, d + W.SCALE_LANES), dtype=wdt,
                              device=x.device)
        q, s_ptr, ld, lds = payload, payload.data_ptr() + d, d + 4, d + 4
    else:
        q = torch.empty((rows, d), dtype=wdt, device=x.device)
        scales = torch.empty((rows,), dtype=torch.float32, device=x.device)
        s_ptr, ld, lds = scales.data_ptr(), d, 4
    err = _quant_fn()(
        x.data_ptr(), int(x.dtype == torch.bfloat16), idx.data_ptr(),
        int(idx.dtype == torch.int64), q.data_ptr(), ld, s_ptr, lds, rows,
        d, int(wire_dtype == "int8"), W.QMAX[wire_dtype],
        W.scale_multiplier(wire_dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "quant_bucket_permute")
    LAUNCHES["quant_bucket_permute"] += 1
    return payload if packed else (q, scales)


def dequant_unbucket_permute(q, scales, idx, out_dtype):
    """K5b. q: (R, d) int8/fp8 CUDA rows with unit column stride and any
    row stride (the q view of a packed payload is taken as it is, with no
    copy); scales: (R,) contiguous f32, or the (R, SCALE_LANES) one-byte
    scale lanes of the same payload; idx: (B,) int32/int64, each a row of
    q. Returns the (B, d) dequantized gathered rows in ``out_dtype``
    (f32 or bf16)."""
    if not q.is_cuda or q.dtype not in _WIRE.values() or q.dim() != 2 \
            or q.stride(1) != 1:
        raise ValueError(f"dequant_unbucket_permute kernel takes (R, d) "
                         f"int8/fp8 CUDA rows with unit column stride, got "
                         f"{q.dtype} {tuple(q.shape)} {q.stride()}")
    if out_dtype not in _IN:
        raise ValueError(f"dequant_unbucket_permute kernel writes f32 or "
                         f"bf16, not {out_dtype}")
    if scales.dtype == torch.float32 and scales.dim() == 1 \
            and scales.is_contiguous():
        lds = 4
    elif scales.element_size() == 1 and scales.shape[1:] == (
            W.SCALE_LANES,) and scales.stride(1) == 1:
        lds = scales.stride(0)
    else:
        raise ValueError(f"scales must be (R,) f32 or (R, {W.SCALE_LANES}) "
                         f"byte lanes, got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    if scales.device != q.device or scales.shape[0] != q.shape[0]:
        raise ValueError("scales must hold one scale per row of q, on "
                         "q's device")
    _check_idx("dequant_unbucket_permute", idx, q.device)
    rows, d = idx.shape[0], q.shape[1]
    out = torch.empty((rows, d), dtype=out_dtype, device=q.device)
    err = _dequant_fn()(
        q.data_ptr(), q.stride(0), scales.data_ptr(), lds, idx.data_ptr(),
        int(idx.dtype == torch.int64), out.data_ptr(),
        int(out_dtype == torch.bfloat16), rows, d,
        int(q.dtype == torch.int8),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "dequant_unbucket_permute")
    LAUNCHES["dequant_unbucket_permute"] += 1
    return out
