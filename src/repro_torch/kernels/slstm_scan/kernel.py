"""Launch the CUDA sLSTM scan kernel (``csrc/slstm_scan.cu``).

Replaces ``src/repro/kernels/slstm_scan/kernel.py::slstm_scan_pallas``.
Each head's Dh output units are cut into slices; one block owns one
(batch group, head, slice) for all S steps, with the slice's columns of
the four recurrent blocks resident in its registers and shared memory,
and the slices of a head exchange h through the L2 every step, each h
word carrying its step. The blocks of a launch must be co-resident, so
:func:`plan` sizes the slices and spreads the (batch group, head) pairs
over consecutive launches from the card's SM count, shared memory and
occupancy; the launch is cooperative, which refuses a grid that could not
be. The source file says what bounds the kernel. The four preactivations
are read in the model's (B, S, H, Dh) layout through their strides, so no
pad or copy is made.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.kernels import build

SOURCE = "src/repro_torch/kernels/csrc/slstm_scan.cu"
MAX_DH = 512
# csrc's kThreads, kRegRows and kAhead: threads a block, R rows a thread
# keeps in registers, h rows a thread reads ahead of its products. The
# card's plan takes a block's shared memory from the C side
# (sfpl_slstm_scan_smem); smem_bytes mirrors it for the plan's CPU tests,
# and a card test holds the two equal.
THREADS = 512
REG_ROWS = 48
AHEAD = 2


def _ceil(a, b):
    return -(-a // b)


def smem_bytes(dh, units, rows):
    """Dynamic shared memory of a block, all f32, as csrc's ``layout``
    carves it. Its 4 x units columns of R are split over K = THREADS //
    (4 units) row chunks of ceil(Dh / K) rows, one thread a (column,
    chunk); a thread keeps REG_ROWS rows of its chunk in registers and the
    rest here. Then h of its rows padded to 4, over the chunks' rows plus
    REG_ROWS + AHEAD (zeros past Dh, which the register rows and the
    read-ahead reach), the partial sums (K x 4 x 4 units) and their totals
    (4 x 4 units)."""
    cols = 4 * units
    k = THREADS // cols
    chunk = _ceil(dh, k)
    return 4 * (k * max(0, chunk - REG_ROWS) * cols
                + (k * chunk + REG_ROWS + AHEAD) * _ceil(rows, 4) * 4
                + 4 * k * cols + 4 * cols)


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel covers a (B, H, Dh) scan.

    A block holds ``rows`` batch rows (its group; the last group of B may
    hold fewer) and ``units`` output units of one head (its slice; the
    last slice of a head may hold fewer), ``slices`` slices a head. A pair
    is a (group, head), numbered ``group * H + head``; ``launches`` lists
    each launch's (first pair, pairs), every pair's slices in one launch.
    ``smem`` is a block's dynamic shared memory in bytes."""
    rows: int
    units: int
    slices: int
    groups: int
    launches: tuple
    smem: int


def plan(B, H, Dh, sm_count, smem_limit, blocks_per_sm, smem=smem_bytes):
    """The launch plan of a (B, H, Dh) scan on a card with ``sm_count`` SMs,
    ``smem_limit`` bytes of shared memory a block, and ``blocks_per_sm(s)``
    co-resident blocks an SM at ``s`` bytes a block (the occupancy query);
    ``smem(Dh, units, rows)`` is a block's shared memory in bytes.

    Every launch's blocks must be co-resident, and each launch runs all S
    steps, so the plan takes, over the batch groupings and slice widths
    that fit in shared memory: the fewest launches; then the fewest blocks
    an SM (blocks on one SM add barrier arrivals and reloads of h, not
    compute); then the least work a block and step (batch rows, which the
    kernel takes 4 at a time, x units), which spreads a step over the most
    SMs. Raises if nothing fits."""
    if min(B, H, Dh, sm_count) < 1:
        raise ValueError(f"slstm_scan plan: B, H, Dh and SMs >= 1; got "
                         f"{(B, H, Dh, sm_count)}")
    best = None
    for rows in sorted({_ceil(B, g) for g in range(1, B + 1)}):
        if rows > THREADS:
            break
        groups = _ceil(B, rows)
        pairs = groups * H
        for units in range(1, min(Dh, THREADS // 4, THREADS // rows) + 1):
            size = smem(Dh, units, rows)
            if size > smem_limit:
                continue
            slices = _ceil(Dh, units)
            per = sm_count * blocks_per_sm(size) // slices
            if per < 1:
                continue
            n = _ceil(pairs, per)
            step = _ceil(pairs, n)          # pairs a launch, the last fewer
            key = (n, _ceil(step * slices, sm_count), _ceil(rows, 4) * units)
            if best is None or key < best[0]:
                best = (key, Plan(rows, units, slices, groups, tuple(
                    (p0, min(step, pairs - p0))
                    for p0 in range(0, pairs, step)), size))
    if best is None:
        raise ValueError(f"slstm_scan plan: no block of Dh {Dh} fits in "
                         f"{smem_limit} B of shared memory and is "
                         f"co-resident on {sm_count} SMs")
    return best[1]


def blocks(pl, B, H, Dh):
    """Per launch of ``pl``, the (b0, nb, head, u0, nu) of each block in
    ``blockIdx.x`` order, as the kernel derives them: batch rows b0 ..
    b0 + nb and units u0 .. u0 + nu of one head."""
    out = []
    for pair0, pairs in pl.launches:
        launch = []
        for x in range(pairs * pl.slices):
            pair, s = pair0 + x // pl.slices, x % pl.slices
            b0 = pair // H * pl.rows
            u0 = s * pl.units
            launch.append((b0, min(pl.rows, B - b0), pair % H, u0,
                           min(pl.units, Dh - u0)))
        out.append(launch)
    return out


def bind(lib):
    """Declare the C entry points' types on a library built from
    ``csrc/slstm_scan.cu`` (the default build or a measurement build)."""
    lib.sfpl_slstm_scan.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int64] * 4 + [ctypes.c_void_p]
        + [ctypes.c_int] * 5 + [ctypes.c_int64, ctypes.c_void_p])
    lib.sfpl_slstm_scan.restype = ctypes.c_int
    lib.sfpl_slstm_scan_smem.argtypes = [ctypes.c_int64, ctypes.c_int,
                                         ctypes.c_int]
    lib.sfpl_slstm_scan_smem.restype = ctypes.c_int64
    lib.sfpl_slstm_scan_resources.argtypes = [
        ctypes.c_int64] + [ctypes.POINTER(ctypes.c_int)] * 4
    lib.sfpl_slstm_scan_resources.restype = ctypes.c_int
    return lib


@functools.cache
def _lib():
    return bind(build.library("slstm_scan"))


@functools.cache
def _resources(smem, device, lib):
    with torch.cuda.device(device):
        out = [ctypes.c_int(0) for _ in range(4)]
        build.check(lib.sfpl_slstm_scan_resources(
            smem, *map(ctypes.byref, out)), "slstm_scan resources")
    return tuple(x.value for x in out)


def resources(smem, device=None, lib=None):
    """The card's report on the kernel at ``smem`` bytes of dynamic shared
    memory a block: threads a block, registers a thread, co-resident blocks
    an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the
    opt-in shared memory a block allows. Builds the library on first use;
    ``lib``, a measurement build from :func:`bind`, in its place."""
    return dict(zip(("threads", "registers", "blocks_per_sm", "smem_limit"),
                    _resources(smem, device, lib or _lib())))


def smem_of(dh, units, rows, lib=None):
    """A block's dynamic shared memory in bytes, from the C side's layout
    (``lib``: a measurement build, else the default one)."""
    size = (lib or _lib()).sfpl_slstm_scan_smem(dh, units, rows)
    if size < 0:
        raise ValueError(f"slstm_scan: no block of (Dh, units, rows) "
                         f"{(dh, units, rows)}")
    return size


@functools.cache
def card_plan(B, H, Dh, device=None, lib=None):
    """:func:`plan` for the card ``device``: its SM count from
    ``torch.cuda.get_device_properties``, its shared-memory limit,
    occupancy and a block's shared memory from the C side (``lib``, a
    measurement build, else the default one). Cached: the plan depends on
    nothing else."""
    device = torch.device("cuda", torch.cuda.current_device()
                          if device is None else device)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    limit = resources(0, device.index, lib)["smem_limit"]
    return plan(B, H, Dh, sms, limit,
                lambda s: resources(s, device.index, lib)["blocks_per_sm"],
                smem=lambda *a: smem_of(*a, lib=lib))


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


def slstm_scan(pre_i, pre_f, pre_z, pre_o, R, lib=None):
    """pre_*: (B, S, H, Dh) f32 on the card, any strides with a unit last
    one; R: (4, H, Dh, Dh) f32. Returns h (B, S, H, Dh) f32, contiguous,
    from the initial state (c 0, n 1e-6, m -1e30, h 0). One cooperative
    launch or more, per :func:`card_plan`; counted once. ``lib``: a
    measurement build from :func:`bind` (``probe.py``), else the default
    one."""
    pres = (pre_i, pre_f, pre_z, pre_o)
    _check(pres, R)
    B, S, H, Dh = pre_i.shape
    dev = pre_i.device
    R = R.contiguous()
    out = torch.empty((B, S, H, Dh), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = lib or _lib()
    pl = card_plan(B, H, Dh, dev.index, lib)
    # the exchange ring, zero every call (so that a CUDA-graph replay
    # starts from zero too): a two-step ring of {h, step} words a pair
    ring = torch.zeros(pl.groups * H * 2 * pl.rows * Dh, dtype=torch.int64,
                       device=dev)
    strides = (ctypes.c_int64 * 12)(*(s for t in pres
                                      for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for pair0, pairs in pl.launches:
            err = lib.sfpl_slstm_scan(
                *(t.data_ptr() for t in pres), R.data_ptr(), out.data_ptr(),
                ring.data_ptr(), B, S, H, Dh,
                ctypes.addressof(strides), pl.rows, pl.units, pl.slices,
                pair0, pairs, pl.smem, stream)
            build.check(err, "slstm_scan")
    LAUNCHES["slstm_scan"] += 1
    return out
