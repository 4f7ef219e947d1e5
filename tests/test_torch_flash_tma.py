"""K7's Hopper path, the parts that run on the CPU.

``kernel.tma_geometry`` lays out the tensor maps through which the Hopper
kernel loads q, k and v; the C entry point only encodes them. These tests
hold that geometry against the tensors' own layout: every element a box
would load is the tensor's element at the same index, for contiguous
tensors, the packed-qkv views of
``tests/test_torch_cuda.py::test_flash_attention_reads_strided_views``
and size-1 dimensions with odd strides, at D 64, 128 and 256 (whose
K / V boxes are 64 rows, Q's 128), and what TMA cannot load is refused. A
plain emulation of the kernel's tile walk (128-row q tiles in two 64-row
halves, K / V tiles of ``kv_rows(D)`` keys from the diagonal down, masks
only on tiles that cross a bound, P rounded to bf16) is held against
``ref.attention_ref`` within 2e-2 (tests/test_kernels.py's bf16 bound) at
the tile edges, and the
tiles it skips or leaves unmasked are checked to need no mask. At D 256
two 64-key tiles cross the causal diagonal of a q tile (the upper one
wholly masked for the first 64-row half), and a window's edge can cross
a third.
"""
import math

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as flash_k
from repro_torch.kernels.flash_attention import ref as flash_ref

BF16 = torch.bfloat16


def _loaded_box(t, geom, x, head, s0, b):
    """What a TMA load of the box at coordinates (64 x, head, s0, b) puts
    in shared memory, before the swizzle: (rows, 64) elements read through
    the geometry's dims and byte strides from the tensor's storage, zero
    past the tensor's dims."""
    dims, strides, box = geom
    es = t.element_size()
    storage = torch.tensor([], dtype=t.dtype).set_(t.untyped_storage())
    base = t.storage_offset()
    out = torch.zeros(box[2], box[0], dtype=t.dtype)
    for r in range(box[2]):
        s = s0 + r
        if s >= dims[2]:
            continue
        for col in range(box[0]):
            d = box[0] * x + col
            off = d * es + head * strides[0] + s * strides[1] + b * strides[2]
            assert off % es == 0
            out[r, col] = storage[base + off // es]
    return out


def _assert_geometry_matches(t, rows):
    geom = flash_k.tma_geometry(t, rows)
    dims, strides, box = geom
    b, s, n, d = t.shape
    assert dims == (d, n, s, b)
    assert box == (64, 1, rows, 1) and box[0] * t.element_size() == 128
    assert d % box[0] == 0          # D / 64 boxes: two at D 128, four at 256
    assert all(st % 16 == 0 and 0 < st < 2 ** 40 for st in strides)
    for dim, st in zip((2, 1, 0), strides):
        if t.shape[dim] > 1:
            assert st == t.stride(dim) * t.element_size()
    gen = torch.Generator().manual_seed(d + s)
    for _ in range(3):
        bi = int(torch.randint(0, b, (1,), generator=gen))
        hi = int(torch.randint(0, n, (1,), generator=gen))
        s0 = int(torch.randint(0, s, (1,), generator=gen))
        for x in range(d // 64):
            got = _loaded_box(t, geom, x, hi, s0, bi)
            want = torch.zeros_like(got)
            seg = t[bi, s0:s0 + rows, hi, 64 * x:64 * x + 64]
            want[:seg.shape[0]] = seg
            assert torch.equal(got, want)


def _numbered(shape):
    """bf16 values that tell elements apart (exact up to 256)."""
    n = math.prod(shape)
    return (torch.arange(n) % 251).to(BF16).reshape(shape)


@pytest.mark.parametrize("shape", [(1, 5, 1, 64), (2, 130, 4, 128),
                                   (3, 17, 2, 64), (1, 129, 8, 128)])
@pytest.mark.parametrize("rows", [flash_k.Q_ROWS, flash_k.kv_rows(128)])
def test_tma_geometry_contiguous(shape, rows):
    t = _numbered(shape)
    _assert_geometry_matches(t, rows)
    b, s, n, d = shape
    assert flash_k.tma_geometry(t, rows)[1] == (2 * d, 2 * n * d,
                                                2 * s * n * d)


@pytest.mark.parametrize("shape", [(1, 65, 2, 256), (2, 130, 4, 256),
                                   (1, 1, 1, 256)])
@pytest.mark.parametrize("rows", [flash_k.Q_ROWS, flash_k.kv_rows(256)])
def test_tma_geometry_d256(shape, rows):
    """D 256: a row is four 64-column boxes; q loads in 128-row boxes, k and
    v in 64-row ones."""
    assert flash_k.kv_rows(256) == 64
    t = _numbered(shape)
    _assert_geometry_matches(t, rows)
    assert flash_k.tma_geometry(t, rows)[2] == (64, 1, rows, 1)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_tma_geometry_packed_qkv_views(d):
    """q, k, v as views of one fused projection, as
    test_flash_attention_reads_strided_views builds them, each in the
    kernel's own rows (q 128, k and v ``kv_rows(d)``)."""
    qkv = _numbered((2, 77, 4 + 2 + 2, d))
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    for t, rows in ((q, flash_k.Q_ROWS), (k, flash_k.kv_rows(d)),
                    (v, flash_k.kv_rows(d))):
        _assert_geometry_matches(t, rows)
        assert flash_k.tma_geometry(t, rows)[1] == (2 * d, 2 * 8 * d,
                                                    2 * 77 * 8 * d)


def test_tma_geometry_size_one_dims_take_a_packed_stride():
    """A size-1 dimension's stride is never used; odd ones (as views make
    them) are replaced by the packed extent, which TMA accepts."""
    t = _numbered((1, 40, 1, 128)).as_strided((1, 40, 1, 128),
                                              (1, 128, 3, 1))
    dims, strides, _ = flash_k.tma_geometry(t, 128)
    assert strides == (256, 256, 40 * 256)
    _assert_geometry_matches(t, 128)


def test_tma_geometry_rejects_what_tma_cannot_load():
    flat = torch.zeros(4 * 10 * 4 * 130, dtype=BF16)
    # a sequence stride of 130 * 2 bytes is not a multiple of 16
    with pytest.raises(ValueError, match="multiples of 16"):
        flash_k.tma_geometry(flat.as_strided((2, 10, 1, 64),
                                             (1300, 130, 64, 1)), 128)
    # a base 2 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_k.tma_geometry(flat[1:1 + 2 * 8 * 64].view(2, 8, 1, 64), 128)
    with pytest.raises(ValueError, match="unit stride"):
        flash_k.tma_geometry(torch.zeros(1, 8, 64, 2, dtype=BF16)
                             .transpose(2, 3), 128)
    with pytest.raises(ValueError, match="D in"):
        flash_k.tma_geometry(torch.zeros(1, 8, 2, 32, dtype=BF16), 128)
    with pytest.raises(ValueError, match="bf16"):
        flash_k.tma_geometry(torch.zeros(1, 8, 2, 64), 128)


# --------------------------------------------------------------------------
# the Hopper kernel's tile walk, emulated

def _live_tiles(q0, rows, tile, skv, causal, window):
    """csrc/flash_attention.cu::live_tiles."""
    k_hi = min(skv, q0 + rows) if causal else skv
    k_lo = max(0, q0 - window + 1) if window else 0
    lo = k_lo // tile
    return lo, ((k_hi + tile - 1) // tile if k_hi > k_lo else lo)


def _mask(iq, ik, skv, causal, window):
    ok = ik[None, :] < skv
    if causal:
        ok = ok & (iq[:, None] >= ik[None, :])
    if window:
        ok = ok & (iq[:, None] - ik[None, :] < window)
    return ok


def _emulate_hopper(q, k, v, causal, window):
    """flash_fwd_hopper's arithmetic and schedule on the CPU: q, k, v bf16
    (B, S, heads, D); rows and keys past S read as zeros (TMA's fill)."""
    b, sq, h, d = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    bm, bn = flash_k.Q_ROWS, flash_k.kv_rows(d)
    sl2 = math.log2(math.e) / math.sqrt(d)
    nq, nk = -(-sq // bm), -(-skv // bn)
    qp = torch.zeros(b, nq * bm, h, d, dtype=BF16)
    qp[:, :sq] = q
    kp = torch.zeros(b, nk * bn, h, d, dtype=BF16)
    vp = torch.zeros_like(kp)
    kp[:, :skv] = k.repeat_interleave(g, dim=2)
    vp[:, :skv] = v.repeat_interleave(g, dim=2)
    out = torch.zeros(b, nq * bm, h, d)
    for qt in reversed(range(nq)):               # the launch order
        q0 = qt * bm
        lo, hi = _live_tiles(q0, bm, bn, skv, causal, window or 0)
        rows = torch.arange(q0, q0 + bm)
        for kt in [*range(0, lo), *range(hi, nk)]:   # skipped: all masked
            keys = torch.arange(kt * bn, kt * bn + bn)
            assert not _mask(rows, keys, skv, causal, window).any()
        for c in range(2):
            qw0 = q0 + 64 * c
            if qw0 >= sq:              # no row of this half is stored
                continue
            iq = torch.arange(qw0, qw0 + 64)
            qs = qp[:, qw0:qw0 + 64].float()
            m = torch.full((b, h, 64), -math.inf)
            l = torch.zeros(b, h, 64)
            acc = torch.zeros(b, h, 64, d)
            for kt in range(hi - 1, lo - 1, -1):     # diagonal first
                k0 = kt * bn
                ik = torch.arange(k0, k0 + bn)
                ok = _mask(iq, ik, skv, causal, window)
                s = torch.einsum("bqhd,bkhd->bhqk", qs,
                                 kp[:, k0:k0 + bn].float())
                edge = (k0 + bn > skv or (causal and k0 + bn - 1 > qw0)
                        or bool(window) and qw0 + 63 - k0 >= window)
                if not edge:                     # unmasked: needs no mask
                    assert ok.all()
                # the row max of the raw scores, then P = exp2(S sl2 - m)
                mx = torch.where(ok, s, -math.inf).amax(-1)
                mn = torch.maximum(m, mx * sl2)
                ms = torch.where(mn == -math.inf, 0.0, mn)
                a = torch.exp2(m - ms)
                p = torch.where(ok, torch.exp2(s * sl2 - ms[..., None]), 0.0)
                l = l * a + p.sum(-1)
                acc = acc * a[..., None] + torch.einsum(
                    "bhqk,bkhd->bhqd", p.to(BF16).float(),
                    vp[:, k0:k0 + bn].float())
                m = mn
            l = torch.where(l == 0, 1.0, l)
            out[:, qw0:qw0 + 64] = (acc / l[..., None]).permute(0, 2, 1, 3)
    return out[:, :sq].to(BF16)


@pytest.mark.parametrize("s", [100, 127, 128, 129, 255, 300])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (False, 200)])
@pytest.mark.parametrize("hk,d", [((4, 1), 128), ((4, 2), 64)])
def test_hopper_tile_walk_matches_plain(s, causal, window, hk, d):
    h, kh = hk
    gen = torch.Generator().manual_seed(s * 7 + d + (window or 0))
    q, k, v = (torch.randn(1, s, n, d, generator=gen).to(BF16)
               for n in (h, kh, kh))
    got = _emulate_hopper(q, k, v, causal, window)
    want = flash_ref.attention_ref(q, k, v, causal=causal, window=window)
    assert torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("s", [63, 64, 65, 127, 128, 129, 300])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 40), (True, 100),
                                           (False, 200)])
@pytest.mark.parametrize("hk", [(4, 4), (4, 1)])
def test_hopper_d256_tile_walk_matches_plain(s, causal, window, hk):
    """The D 256 walk: 128-row q tiles over 64-key K / V tiles, so two
    tiles cross each q tile's causal diagonal (the upper one wholly masked
    for the first 64-row half) and a window's edge can fall in a third; S around the 64- and 128-row edges, MHA (gemma-7b) and MQA
    (recurrentgemma-9b)."""
    h, kh = hk
    gen = torch.Generator().manual_seed(s * 11 + kh + (window or 0))
    q, k, v = (torch.randn(1, s, n, 256, generator=gen).to(BF16)
               for n in (h, kh, kh))
    got = _emulate_hopper(q, k, v, causal, window)
    want = flash_ref.attention_ref(q, k, v, causal=causal, window=window)
    assert torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)
