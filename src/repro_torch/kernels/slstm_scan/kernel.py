"""Launch the CUDA sLSTM scan kernel (``csrc/slstm_scan.cu``).

Replaces ``src/repro/kernels/slstm_scan/kernel.py::slstm_scan_pallas``.
One block per (batch row, head) walks all S steps with that head's state
on chip; the source file says what bounds it and what its design does
about that. The four preactivations are read in the model's
(B, S, H, Dh) layout through their strides, so no pad or copy is made.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/slstm_scan.cu"
MAX_DH = 512


@functools.cache
def _fn():
    fn = build.library("slstm_scan").sfpl_slstm_scan
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(pres, R):
    x = pres[0]
    if not all(t.is_cuda and t.device == x.device for t in (*pres, R)):
        raise ValueError("slstm_scan kernel: every input must be on one "
                         "CUDA device")
    if any(t.dtype != torch.float32 for t in (*pres, R)):
        raise TypeError(f"slstm_scan kernel takes float32 only; got "
                        f"{[t.dtype for t in (*pres, R)]}")
    if x.dim() != 4 or any(t.shape != x.shape for t in pres):
        raise ValueError(f"slstm_scan kernel: pre_* (B, S, H, Dh) of one "
                         f"shape; got {[tuple(t.shape) for t in pres]}")
    B, S, H, Dh = x.shape
    if tuple(R.shape) != (4, H, Dh, Dh):
        raise ValueError(f"slstm_scan kernel: R (4, H, Dh, Dh) = "
                         f"{(4, H, Dh, Dh)}; got {tuple(R.shape)}")
    if not 1 <= Dh <= MAX_DH:
        raise ValueError(f"slstm_scan kernel: Dh in 1..{MAX_DH}; got {Dh}")
    if any(t.stride(3) != 1 for t in pres):
        raise ValueError(f"slstm_scan kernel: unit stride on Dh needed; got "
                         f"strides {[t.stride() for t in pres]}")


def slstm_scan(pre_i, pre_f, pre_z, pre_o, R):
    """pre_*: (B, S, H, Dh) f32 on the card, any strides with a unit last
    one; R: (4, H, Dh, Dh) f32. Returns h (B, S, H, Dh) f32, contiguous,
    from the initial state (c 0, n 1e-6, m -1e30, h 0)."""
    pres = (pre_i, pre_f, pre_z, pre_o)
    _check(pres, R)
    B, S, H, Dh = pre_i.shape
    R = R.contiguous()
    out = torch.empty((B, S, H, Dh), dtype=torch.float32,
                      device=pre_i.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 12)(*(s for t in pres
                                      for s in t.stride()[:3]))
    err = _fn()(*(t.data_ptr() for t in pres), R.data_ptr(), out.data_ptr(),
                B, S, H, Dh, ctypes.addressof(strides),
                torch.cuda.current_stream(pre_i.device).cuda_stream)
    build.check(err, "slstm_scan")
    LAUNCHES["slstm_scan"] += 1
    return out
