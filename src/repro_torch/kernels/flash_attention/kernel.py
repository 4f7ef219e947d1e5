"""Launch the CUDA flash-attention kernels (``csrc/flash_attention.cu``).

Replaces ``src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd``.
The kernel is bound by operations (the tensor cores) at the prefill's
shapes; the source file says how its design meets that. It reads q, k and
v in the model's (B, S, heads, D) layout through their strides, so no
transpose or padding copy is made around it.

Each (dtype, D) has one kernel: bf16 at D 64, 128 and 256 the Hopper
kernel (TMA loads, ``wgmma``, warp specialisation; 128-row q tiles over
128-key K / V tiles, 64-key ones at D 256), whose tensor maps
:func:`tma_geometry` lays out; bf16 at D 32 the ``mma.sync`` kernel; f32
the plain-FMA kernel. A bf16 input that TMA cannot load at D 64, 128 or
256 (a stride or base off 16 bytes) raises: no other kernel serves it.
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
HEAD_DIMS = (32, 64, 128, 256)
TMA_HEAD_DIMS = (64, 128, 256)  # bf16 head dims of the Hopper kernel
TMA_BOX_BYTES = 128            # the 128-byte swizzle's widest box row
Q_ROWS = 128                   # the Hopper kernel's q tile


def kv_rows(d):
    """Keys in the Hopper kernel's K / V tile at head dim ``d``: 128, or 64
    at D 256, where Q and two ring stages of 128-key tiles would need 320
    KiB of shared memory (csrc/flash_attention.cu::hopper::kv_rows)."""
    return 64 if d > 128 else 128


@functools.cache
def _fn():
    fn = build.library("flash_attention").sfpl_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 6 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _tma_fn():
    fn = build.library("flash_attention").sfpl_flash_attention_tma
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def resources(d, dtype=torch.bfloat16):
    """The card's report on the kernel that serves (D, dtype), named by
    :func:`kernel_for`: registers a thread at launch, local memory a
    thread (the stack frame, where spills go: 0 means none), static and
    dynamic shared memory a CTA, and CTAs an SM (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). Builds the library
    on first use."""
    fn = build.library("flash_attention").sfpl_flash_attention_resources
    fn.argtypes = [ctypes.c_int64, ctypes.c_int] + [
        ctypes.POINTER(ctypes.c_int)] * 5
    fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(5)]
    build.check(fn(d, DTYPES[dtype], *map(ctypes.byref, out)),
                "flash_attention resources")
    return dict(kernel=kernel_for(d, dtype), **dict(zip(
        ("registers", "local_bytes", "smem_static", "smem_dynamic",
         "ctas_per_sm"), (x.value for x in out))))


def kernel_for(d, dtype):
    """The kernel that serves (D, dtype): ``hopper`` (bf16 at D 64, 128,
    256), ``mma_sync`` (bf16 at D 32) or ``fma`` (f32)."""
    if dtype == torch.bfloat16:
        return "hopper" if d in TMA_HEAD_DIMS else "mma_sync"
    return "fma"


def tma_geometry(t, rows):
    """The 4-D tensor map through which the Hopper kernel loads ``t``, a
    bf16 (B, S, heads, D) tensor, in tiles of ``rows`` sequence positions.

    Returns ``(dims, strides, box)`` in the driver's order, innermost
    first: ``dims`` (D, heads, S, B) in elements, ``strides`` the byte
    strides of heads, S and B, and ``box`` (64, 1, rows, 1). A box row is
    64 bf16, the 128 bytes that the 128-byte swizzle allows, so a row of D
    is loaded as D / 64 boxes (the kernel's x = 0 .. D / 64 - 1 at column
    64 x). ``rows`` is :data:`Q_ROWS` for q and :func:`kv_rows` for k, v.
    The stride of a size-1 dimension is never used and is given as the
    packed one (the byte extent of the dimensions inside it). Raises on what TMA cannot load: another dtype or
    D, a non-unit D stride, a base or a used stride that is not a
    multiple of 16 bytes, or a stride of 2**40 bytes or more."""
    if t.dtype != torch.bfloat16 or t.dim() != 4:
        raise ValueError(f"tma_geometry: a 4-D bf16 tensor; got {t.dtype} "
                         f"{tuple(t.shape)}")
    b, s, n, d = t.shape
    if d not in TMA_HEAD_DIMS:
        raise ValueError(f"tma_geometry: D in {TMA_HEAD_DIMS}; got {d}")
    es = t.element_size()
    if t.stride(3) != 1:
        raise ValueError(f"tma_geometry: unit stride on D needed; got "
                         f"strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError("tma_geometry: the base must be 16-byte aligned")
    strides, inner = [], d * es
    for dim in (2, 1, 0):                     # heads, S, B
        st = t.stride(dim) * es if t.shape[dim] > 1 else inner
        if st % 16 or not 0 < st < 2 ** 40:
            raise ValueError(f"tma_geometry: byte strides of heads, S and B "
                             f"must be positive multiples of 16 below 2**40; "
                             f"got {st} on dim {dim} (strides {t.stride()})")
        strides.append(st)
        inner = st * t.shape[dim]
    return ((d, n, s, b), tuple(strides),
            (TMA_BOX_BYTES // es, 1, rows, 1))


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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    w = 0 if window is None else int(window)
    if kernel_for(d, q.dtype) == "hopper":
        if scale < 0:       # its row max is taken on the raw scores
            q, scale = -q, -scale
        geom = (ctypes.c_int64 * 33)(*(x for t, rows in (
            (q, Q_ROWS), (k, kv_rows(d)), (v, kv_rows(d)))
            for part in tma_geometry(t, rows) for x in part))
        ostrides = (ctypes.c_int64 * 3)(*o.stride()[:3])
        err = _tma_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), ctypes.addressof(geom),
                        ctypes.addressof(ostrides), float(scale),
                        int(causal), w, stream)
    else:
        strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                          for s in t.stride()[:3]))
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    b, sq, skv, h, kh, d, ctypes.addressof(strides),
                    float(scale), int(causal), w, DTYPES[q.dtype], stream)
    build.check(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
