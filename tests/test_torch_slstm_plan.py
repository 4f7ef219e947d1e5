"""K8's launch plan and its sliced step, the parts that run on the CPU.

``kernel.plan`` decides how the sLSTM scan kernel covers a (B, H, Dh) scan:
units a slice, batch rows a block, and which (batch group, head) pairs go
to which cooperative launch. These tests hold it, at the shapes the model
and the card tests give it and on SM counts of 132 (H100 SXM) and 114
(H100 PCIe), to three properties: every (batch row, head, unit) is owned
by exactly one block; a block holds its whole R slice, in registers and in
shared memory within the limit it was given, beside h; no launch has more
blocks than can be co-resident. A plain
emulation of the kernel's sliced step (each block computes its units from
the previous full h in the kernel's row-chunk order, then the slices
exchange h) is held against ``ref.slstm_scan_ref`` within 1e-5 at plans
with several slices a head, a ragged last slice, several batch groups and
several launches.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm_scan import kernel as slstm_k
from repro_torch.kernels.slstm_scan import ref as slstm_ref

SMEM_LIMIT = 232_448        # H100: opt-in shared memory a block


def h100_blocks_per_sm(smem):
    """Co-resident 512-thread blocks an H100 SM holds at ``smem`` bytes a
    block, at the kernel's launch bound of 128 registers a thread (65,536
    an SM): one, where 228 KiB of shared memory an SM, 1 KiB reserved a
    block, hold it."""
    return min(65_536 // (slstm_k.THREADS * 128), 233_472 // (smem + 1024))


SHAPES = [
    (4, 4, 512),      # xlstm-1.3b's prefill (B 4 x S 4096)
    (1, 2, 8), (5, 4, 16), (3, 1, 32), (2, 2, 64),   # the card's fuzz grid
    (4, 4, 509),      # a Dh that no slice count divides
    (4, 8, 512),      # H 8: 32 MiB of R
    (4, 12, 512),     # H 12: 48 MiB of R, more than one launch
    (32, 4, 512),     # B 32, the uncut prefill_32k
    (200, 4, 512),    # more rows than one block takes
    (5, 3, 1),
    (4, 40, 128),     # slices of more than 32 units at 4 rows a block
]


def _plan(shape, sms):
    b, h, dh = shape
    return slstm_k.plan(b, h, dh, sms, SMEM_LIMIT, h100_blocks_per_sm)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_every_unit_once(shape, sms):
    b, h, dh = shape
    pl = _plan(shape, sms)
    owners = np.zeros((b, h, dh), dtype=np.int64)
    for launch in slstm_k.blocks(pl, b, h, dh):
        for b0, nb, head, u0, nu in launch:
            assert 1 <= nb <= pl.rows and 1 <= nu <= pl.units
            owners[b0:b0 + nb, head, u0:u0 + nu] += 1
    assert (owners == 1).all()
    assert pl.slices == math.ceil(dh / pl.units)
    assert pl.groups == math.ceil(b / pl.rows)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_block_fits_shared_memory(shape, sms):
    """A block holds its whole R slice, REG_ROWS rows of each thread's row
    chunk in registers and the rest in shared memory, beside h of its
    rows; the kernel's own limits on a block hold."""
    b, h, dh = shape
    pl = _plan(shape, sms)
    cols = 4 * pl.units
    k = slstm_k.THREADS // cols
    chunk = math.ceil(dh / k)
    in_regs = k * min(chunk, slstm_k.REG_ROWS) * cols
    in_smem = k * max(0, chunk - slstm_k.REG_ROWS) * cols
    assert in_regs + in_smem >= dh * cols
    assert in_regs <= slstm_k.THREADS * slstm_k.REG_ROWS
    assert pl.smem == slstm_k.smem_bytes(dh, pl.units, pl.rows)
    assert 4 * (in_smem + dh * pl.rows) <= pl.smem <= SMEM_LIMIT
    assert cols <= slstm_k.THREADS and pl.units * pl.rows <= slstm_k.THREADS


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("shape", SHAPES)
def test_plan_launch_is_co_resident(shape, sms):
    b, h, dh = shape
    pl = _plan(shape, sms)
    co = sms * h100_blocks_per_sm(pl.smem)
    pairs = [p for p0, n in pl.launches for p in range(p0, p0 + n)]
    assert pairs == list(range(pl.groups * h))
    for launch in slstm_k.blocks(pl, b, h, dh):
        assert 1 <= len(launch) <= co


@pytest.mark.parametrize("shape,sms,plan", [
    # one wave of 128 blocks: 64 rows a thread, 48 of them in registers
    ((4, 4, 512), 132, (1, 16, 4)),
    ((4, 4, 512), 114, (1, 19, 4)),     # ragged: 26 slices of 19, one of 18
    ((4, 4, 509), 132, (1, 16, 4)),     # ragged: 31 slices of 16, one of 13
    # 128 rows a thread, 80 of them in shared memory
    ((4, 8, 512), 132, (1, 32, 4)),
    ((4, 8, 512), 114, (2, 19, 4)),
    ((4, 12, 512), 132, (2, 24, 4)),
    ((32, 4, 512), 132, (1, 32, 16)),   # two batch groups in one launch
    ((32, 4, 512), 114, (2, 9, 32)),
    # 4 x 4 units partial-sum totals a block, more than its 512 threads
    ((4, 40, 128), 132, (1, 43, 4)),
    ((4, 40, 128), 114, (1, 64, 4)),
])
def test_plan_at_the_model_shapes(shape, sms, plan):
    """(launches, units, rows) of the plan."""
    pl = _plan(shape, sms)
    assert (len(pl.launches), pl.units, pl.rows) == plan


def test_plan_raises_where_nothing_fits():
    with pytest.raises(ValueError, match="fits"):
        slstm_k.plan(4, 4, 512, 132, 4 * 1024, h100_blocks_per_sm)
    with pytest.raises(ValueError, match="co-resident"):
        slstm_k.plan(4, 4, 512, 132, SMEM_LIMIT, lambda smem: 0)


def emulate(pres, R, pl):
    """The kernel's arithmetic, block by block: in each launch, every step,
    each block sums its units' recurrent products over the row chunks of
    its dot-product threads (K = THREADS // (4 units) chunks; the even and
    the odd chunks in two chains) from the previous step's full h, which it
    reads back from ``out`` (the exchange), applies the gates with its own
    (c, n, m), and writes its units' h; no block sees this step's h of
    another. NaN marks what no block wrote."""
    B, S, H, Dh = pres[0].shape
    out = torch.full((B, S, H, Dh), float("nan"))
    k = slstm_k.THREADS // (4 * pl.units)
    chunk = math.ceil(Dh / k)
    for launch in slstm_k.blocks(pl, B, H, Dh):
        state = [(torch.zeros(nb, nu), torch.full((nb, nu), 1e-6),
                  torch.full((nb, nu), -1e30))
                 for _, nb, _, _, nu in launch]
        for t in range(S):
            new = []
            for x, (b0, nb, head, u0, nu) in enumerate(launch):
                h = out[b0:b0 + nb, t - 1, head] if t else torch.zeros(nb, Dh)
                cols = R[:, head, :, u0:u0 + nu]                 # (4, Dh, nu)
                chains = [0, 0]
                for kk, d0 in enumerate(range(0, Dh, chunk)):
                    chains[kk % 2] = chains[kk % 2] + torch.einsum(
                        "bd,gdu->gbu", h[:, d0:d0 + chunk],
                        cols[:, d0:d0 + chunk])
                rec = chains[0] + chains[1]
                xs = [p[b0:b0 + nb, t, head, u0:u0 + nu] for p in pres]
                c, n, m = state[x]
                i_pre = xs[0] + rec[0]
                logf = F.logsigmoid(xs[1] + rec[1])
                z = torch.tanh(xs[2] + rec[2])
                o = torch.sigmoid(xs[3] + rec[3])
                m_new = torch.maximum(logf + m, i_pre)
                i_s = torch.exp(i_pre - m_new)
                f_s = torch.exp(logf + m - m_new)
                c = f_s * c + i_s * z
                n = torch.clamp_min(f_s * n + i_s, 1e-6)
                state[x] = (c, n, m_new)
                new.append(o * (c / n))
            for (b0, nb, head, u0, nu), h in zip(launch, new):
                out[b0:b0 + nb, t, head, u0:u0 + nu] = h
    return out


@pytest.mark.parametrize("b,s,h,dh,plan", [
    # slices of 4 units (the last of 1), a launch a pair
    (3, 5, 3, 13, slstm_k.Plan(3, 4, 4, 1, ((0, 1), (1, 1), (2, 1)), 0)),
    # batch groups of 3 and 2 rows, two pairs a launch
    (5, 4, 2, 13, slstm_k.Plan(3, 4, 4, 2, ((0, 2), (2, 2)), 0)),
    # slices of 16 units (the last of 2): 8 chunks of 63 rows a column,
    # 48 of them in registers and 15 in shared memory
    (2, 3, 2, 498, slstm_k.Plan(2, 16, 32, 1, ((0, 2),), 0)),
    # slices of 43 units (the last of 42) at 4 rows: 2 chunks a column
    (4, 4, 2, 128, slstm_k.Plan(4, 43, 3, 1, ((0, 2),), 0)),
])
def test_sliced_step_emulation_matches_ref(b, s, h, dh, plan):
    pairs = [p for p0, n in plan.launches for p in range(p0, p0 + n)]
    assert pairs == list(range(plan.groups * h))
    assert plan.slices > 1 and dh % plan.units
    rng = np.random.default_rng(b * 100 + dh)
    pres = [torch.from_numpy(rng.standard_normal((b, s, h, dh),
                                                 dtype=np.float32))
            for _ in range(4)]
    R = torch.from_numpy(rng.standard_normal((4, h, dh, dh),
                                             dtype=np.float32)
                         * (0.3 if dh < 100 else dh ** -0.5))
    got = emulate(pres, R, plan)
    want, _ = slstm_ref.slstm_scan_ref(*pres, R, slstm_ref.initial_state(
        b, h, dh))
    assert torch.isfinite(got).all()
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5)
