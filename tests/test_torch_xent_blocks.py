"""The cross-entropy kernels' shared geometry (K3f and K3b), on the CPU.

Pure Python over the launch arithmetic of
``repro_torch.kernels.softmax_xent.kernel``: for every width and row count
the grid covers each row and column once, a thread holds no more values
than the stated cap, the warps are 1, 2, 4 or 8, and the main path's 800 x
100 pool spreads over more programs than an H100 has SMs (132). The
wrappers are driven with stand-in launchers to show that both directions
launch the geometry's grid and block sizes.
"""
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.kernels.softmax_xent import kernel as xent_k

WIDTHS = (1, 2, 13, 100, 127, 128, 129, 1000, 16384, 16385, 50257)
ROWS = (1, 4, 33, 800, 131073)
H100_SMS = 132


def covered(n, block, programs):
    """Whether ``programs`` blocks of ``block`` starting at 0 tile [0, n)
    with every block holding at least one index (the kernels' ``rows < R``
    and ``cols < V`` masks cut the last one)."""
    return programs * block >= n and (programs - 1) * block < n


def values_per_thread(geo):
    """Values a thread holds (at least one: a block smaller than its warps
    is held in copies)."""
    return -(-geo.rows * geo.block_v // (32 * geo.warps))


def value_cap(geo):
    """16 values a thread up to 4,096 columns a program; one row in 8
    warps past that holds ``block_v / 256``."""
    return max(16, geo.block_v // 256)


@pytest.mark.parametrize("r", ROWS)
@pytest.mark.parametrize("v", WIDTHS)
def test_geometry_covers_once_within_caps(v, r):
    # the forward's geometry, then the backward's: the same up to MAX_V
    fwd, bwd = xent_k.geometry(v), xent_k.geometry(v, xent_k.WIDE_BWD_V)
    for geo, wide_v in ((fwd, xent_k.WIDE_V), (bwd, xent_k.WIDE_BWD_V)):
        assert covered(r, geo.rows, geo.programs(r))
        assert covered(v, geo.block_v, geo.col_blocks)
        assert geo.block_v & (geo.block_v - 1) == 0
        assert geo.warps in (1, 2, 4, 8)
        assert 1 <= values_per_thread(geo) <= value_cap(geo) <= 64
        if v <= xent_k.MAX_V:
            assert geo == fwd and geo.col_blocks == 1
            assert geo.block_v < 2 * v and geo.rows == (4 if v <= 128
                                                        else 1)
        else:
            assert (geo.rows, geo.block_v, geo.warps) == (1, wide_v, 8)
        if v <= 4096:
            assert values_per_thread(geo) <= 16
        if (r, v) == (800, 100):
            assert geo.programs(r) >= H100_SMS


class _Launcher:
    """Stands in for a compiled Triton kernel; records ``kernel[grid](...)``
    calls."""

    def __init__(self, calls, name):
        self.calls, self.name = calls, name

    def __getitem__(self, grid):
        def launch(*args, **meta):
            self.calls.append((self.name, grid, args, meta))
        return launch


@pytest.mark.parametrize("r,v", [(800, 100), (33, 129), (5, 1000),
                                 (3, 16385)])
def test_both_directions_launch_the_geometry(monkeypatch, r, v):
    calls = []
    monkeypatch.setattr(xent_k, "_kernels", lambda: tuple(
        _Launcher(calls, n) for n in ("fwd", "bwd", "fwd_wide")))
    monkeypatch.setattr(xent_k, "_check", lambda *a: None)
    monkeypatch.setitem(K.LAUNCHES, "xent_fwd", 0)
    monkeypatch.setitem(K.LAUNCHES, "xent_bwd", 0)
    x = torch.zeros(r, v, dtype=torch.bfloat16)
    lab = torch.zeros(r, dtype=torch.int64)
    nll, lse = xent_k.xent_fwd(x, lab)
    dx = xent_k.xent_bwd(x, lab, lse, torch.ones(r))
    assert nll.shape == lse.shape == (r,) and dx.shape == x.shape
    assert dx.dtype == x.dtype
    assert K.LAUNCHES["xent_fwd"] == K.LAUNCHES["xent_bwd"] == 1
    geo = xent_k.geometry(v)
    (fname, fgrid, _, fmeta), (bname, bgrid, _, bmeta) = calls
    if geo.col_blocks > 1:
        assert (fname, fgrid) == ("fwd_wide", (r,))
        assert fmeta == dict(BLOCK_V=geo.block_v, num_warps=geo.warps)
    else:
        assert (fname, fgrid) == ("fwd", (geo.programs(r),))
        assert fmeta == dict(BLOCK_R=geo.rows, BLOCK_V=geo.block_v,
                             num_warps=geo.warps)
    geo = xent_k.geometry(v, xent_k.WIDE_BWD_V)
    assert (bname, bgrid) == ("bwd", (geo.programs(r), geo.col_blocks))
    assert bmeta == dict(BLOCK_R=geo.rows, BLOCK_V=geo.block_v,
                         num_warps=geo.warps)
