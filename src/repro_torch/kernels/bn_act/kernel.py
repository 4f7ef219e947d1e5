"""Launch the CUDA BN affine + ReLU kernel (``csrc/bn_act.cu``) and the
BatchNorm training op's kernels beside it.

K2 (``bn_act``) replaces ``src/repro/kernels/bn_act/kernel.py::bn_act_2d``.
``bn_moments`` (the batch moments, the fold and the running update) and
``bn_grad`` (the backward's reduction and ``dx`` pass) replace no TPU
kernel: they replace plain PyTorch around K2. All are bound by bytes; the
source file says how their design meets that. Each launcher counts one
launch of its family (``bn_grad``'s is two kernels) and the bytes its
pure byte function gives.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import count
from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/bn_act.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


STAT_THREADS = 256      # threads a block of the training op's kernels
BLOCKS_PER_SM = 4       # their __launch_bounds__ minimum
MIN_TILES = 16          # tiles a block of the reductions takes at least
DX_BLOCKS_PER_SM = 32   # blocks of the dx pass over all groups, an SM


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


@functools.cache
def _sms(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _moments_fn():
    fn = build.library("bn_act").sfpl_bn_moments
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int64] + [ctypes.c_void_p] * 8
                   + [ctypes.c_float] * 3
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _grad_fn():
    fn = build.library("bn_act").sfpl_bn_grad
    fn.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stat_geometry(groups, rows, c, elem_bytes, aligned, sms):
    """``(vec, rows_per_tile, parts, dx_parts)`` of the training op's
    kernels: 16-byte vectors where ``c`` is a multiple of one and every
    operand is ``aligned`` to 16 bytes, else single elements; a block of
    ``STAT_THREADS`` covers ``rows_per_tile`` rows a tile (a thread each
    ``vec`` channels of one row); ``parts`` blocks a group for the
    reductions (about ``BLOCKS_PER_SM`` an SM over all groups, so that
    all are resident at once, and at least ``MIN_TILES`` tiles a block,
    so that a small input leaves its group's last block few partials to
    merge), ``dx_parts`` for the dx pass."""
    full = 16 // elem_bytes
    vec = full if aligned and c % full == 0 else 1
    if c // vec > STAT_THREADS:
        raise ValueError(f"BatchNorm kernels take at most "
                         f"{STAT_THREADS * vec} channels here, got {c}")
    tile = STAT_THREADS // (c // vec)
    tiles = -(-rows // tile)
    parts = max(1, min(-(-tiles // MIN_TILES),
                       BLOCKS_PER_SM * sms // groups))
    dx_parts = max(1, min(tiles, DX_BLOCKS_PER_SM * sms // groups))
    return vec, tile, parts, dx_parts


def bn_moments_bytes(elems, elem_bytes, groups, channels, parts, training):
    """Bytes one ``bn_moments`` launch moves: ``x`` read; ``scale`` and
    ``bias`` read; the partials (a count and each channel's mean and M2, a
    block) and the groups' tickets written and read once; the five f32
    results a channel written; when ``training``, the running mean, var
    and count read and their new values written."""
    gc = groups * channels * 4
    work = groups * parts * (2 * channels + 1) * 4 + groups * 4
    run = 2 * (2 * gc + groups * 4) if training else 0
    return elems * elem_bytes + 2 * gc + 2 * work + 5 * gc + run


def bn_grad_bytes(elems, elem_bytes, groups, channels, parts):
    """Bytes one ``bn_grad`` launch (two kernels) moves, every operand
    byte read once and every output byte written once: ``g`` and ``x``
    read and ``dx`` written; four of the f32 results of the moments read
    (mean, a, b, rstd); the partials (two sums a channel, a block) and the
    groups' tickets, and the two coefficients of ``dx`` a channel,
    written and read once; ``dscale`` and ``dbias`` written."""
    gc = groups * channels * 4
    work = groups * parts * 2 * channels * 4 + groups * 4
    return 3 * elems * elem_bytes + 4 * gc + 2 * work + 2 * 2 * gc + 2 * gc


def _stat_checks(name, x, *vectors):
    if not (x.is_cuda and all(v.device == x.device for v in vectors)):
        raise ValueError(f"{name} kernel: all operands on one CUDA device")
    if x.dtype not in DTYPES:
        raise TypeError(f"{name} kernel takes {list(DTYPES)}, got {x.dtype}")
    if x.dim() != 3 or x.shape[1] == 0:
        raise ValueError(f"{name} kernel: x (G, rows, C) with rows > 0; "
                         f"got {tuple(x.shape)}")
    if not all(v.dtype == torch.float32 and v.is_contiguous()
               for v in vectors) or not x.is_contiguous():
        raise ValueError(f"{name} kernel needs contiguous inputs and f32 "
                         f"per-channel operands")


def bn_moments(x, scale, bias, run_mean, run_var, run_count, *, momentum,
               eps, training):
    """The batch moments of x (G, rows, C) over its rows, in f32 from
    ``x.dtype``, with the fold and the running update, in one launch.

    scale, bias, run_mean, run_var: (G, C) f32; run_count: (G,) f32.
    Returns ``stats`` (5, G, C) f32, the rows mean, biased var,
    ``a = scale / sqrt(var + eps)``, ``b = bias - mean * a`` and
    ``rstd = 1 / sqrt(var + eps)``, and, when ``training``, the new
    running ``(mean, var, count)``: ``momentum * old + (1 - momentum) *
    batch`` and ``count + 1`` (else ``None``)."""
    _stat_checks("bn_moments", x, scale, bias, run_mean, run_var, run_count)
    g, rows, c = x.shape
    if any(t.shape != (g, c) for t in (scale, bias, run_mean, run_var)) \
            or run_count.shape != (g,):
        raise ValueError(f"bn_moments kernel: (G, C) = {(g, c)} vectors and "
                         f"a (G,) count")
    vec, _, parts, _ = stat_geometry(g, rows, c, x.element_size(),
                                     x.data_ptr() % 16 == 0,
                                     _sms(x.device.index))
    ws = torch.empty(g * parts * (2 * c + 1) + g, dtype=torch.float32,
                     device=x.device)
    stats = torch.empty(5, g, c, dtype=torch.float32, device=x.device)
    new = (torch.empty_like(run_mean), torch.empty_like(run_var),
           torch.empty_like(run_count)) if training else None
    ptrs = [t.data_ptr() for t in new] if training else [None] * 3
    err = _moments_fn()(x.data_ptr(), g, rows, c, DTYPES[x.dtype], vec, parts,
                        scale.data_ptr(), bias.data_ptr(),
                        run_mean.data_ptr(), run_var.data_ptr(),
                        run_count.data_ptr(), *ptrs, momentum, 1 - momentum,
                        eps, int(training), ws.data_ptr(), stats.data_ptr(),
                        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "bn_moments")
    count("bn_moments", bn_moments_bytes(x.numel(), x.element_size(), g, c,
                                         parts, training))
    return stats, new


def bn_grad(gy, x, stats, *, relu):
    """The backward of the BatchNorm training op at ``x`` (G, rows, C)
    with the ``stats`` of :func:`bn_moments`, for the gradient ``gy`` of
    ``relu?(x * a + b)`` (the ReLU mask recomputed from x, a, b with K2's
    rounding). Returns ``dx`` in ``x.dtype`` and the f32 ``dscale``,
    ``dbias`` (G, C)."""
    _stat_checks("bn_grad", x, stats)
    g, rows, c = x.shape
    if gy.shape != x.shape or gy.dtype != x.dtype or gy.device != x.device \
            or not gy.is_contiguous() or stats.shape != (5, g, c):
        raise ValueError("bn_grad kernel: gy like x, contiguous; stats "
                         "(5, G, C)")
    dx = torch.empty_like(x)
    aligned = all(t.data_ptr() % 16 == 0 for t in (gy, x, dx))
    vec, _, parts, dx_parts = stat_geometry(g, rows, c, x.element_size(),
                                            aligned, _sms(x.device.index))
    ws = torch.empty(g * parts * 2 * c + g, dtype=torch.float32,
                     device=x.device)
    coef = torch.empty(4, g, c, dtype=torch.float32, device=x.device)
    err = _grad_fn()(gy.data_ptr(), x.data_ptr(), dx.data_ptr(), g, rows, c,
                     DTYPES[x.dtype], vec, parts, dx_parts, stats.data_ptr(),
                     int(relu), ws.data_ptr(), coef.data_ptr(),
                     torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "bn_grad")
    count("bn_grad", bn_grad_bytes(x.numel(), x.element_size(), g, c, parts))
    return dx, coef[2], coef[3]
