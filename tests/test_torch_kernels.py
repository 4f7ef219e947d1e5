"""Each kernel's plain PyTorch version against the JAX Pallas kernel.

The Pallas kernels run in interpret mode on the CPU, as tests/test_kernels.py
runs them; the port's wrappers, given CPU tensors, run their plain
versions. Inputs are made with numpy from a seed; bf16 inputs are rounded
to bf16 identically on both sides. Tolerances: permute and the route
plan's bucket gathers (K4a/K4b) bitwise, their scatter-add gradients
1e-6; the quantize/dequantize gathers (K5a/K5b) bitwise, in quantized
bytes, scales and dequantized values, with their straight-through
gradient 1e-6; bn_act 1e-6 in f32 and 1 bf16 ulp; softmax_xent value and
logits-grad 1e-5 in f32 and 1e-2 in bf16; rmsnorm (K6) 1e-5 in f32 and
2e-2 in bf16; flash attention (K7): the port's plain version 1e-5 of the
JAX package's ``attention_ref`` in f32, and 2e-3 (f32) / 2e-2 (bf16) of
the Pallas kernel, tests/test_kernels.py's bounds. The shapes are
tests/test_kernels.py's fuzz shapes (ragged widths, repeated indices,
B != R), plus flash attention at head_dim 256 (MHA and MQA, causal and
windowed) and softmax_xent at 20,000 classes, past the port's one-block
width. Each differentiable ``autograd.Function`` also passes
``torch.autograd.gradcheck`` in float64 on the plain path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as JW
from repro.kernels.bn_act.ops import bn_act as j_bn_act
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_attn_ref
from repro.kernels.rmsnorm.ops import rmsnorm as j_rmsnorm
from repro.kernels.collector_permute.ops import (
    bucket_permute as j_bucket, bucket_permute_ad as j_bucket_ad,
    collector_permute as j_permute, collector_permute_ad as j_permute_ad,
    unbucket_permute as j_unbucket, unbucket_permute_ad as j_unbucket_ad)
from repro.kernels.quant_permute.ops import (
    dequant_unbucket_permute as j_dequant,
    quant_bucket_permute as j_quant,
    quant_dequant_roundtrip_ad as j_roundtrip)
from repro.kernels.softmax_xent.ops import softmax_xent as j_xent
from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.collector_permute import ops as perm_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.quant_permute import ops as quant_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.softmax_xent import ops as xent_ops

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a, dtype):
    """The same numpy values as a JAX array and a torch tensor, rounded to
    ``dtype`` identically."""
    jd, td = DT[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------------------
# K1 collector_permute

@pytest.mark.parametrize("rows,feat", [(2, (16,)), (13, (100,)),
                                       (7, (513,)), (33, (4, 4, 8))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_collector_permute_plain_matches_pallas(rows, feat, dtype):
    rng = np.random.default_rng(rows)
    xj, xt = _pair(rng.standard_normal((rows,) + feat).astype(np.float32),
                   dtype)
    perm = rng.permutation(rows)
    out_j = j_permute(xj, jnp.asarray(perm), interpret=True)
    xt.requires_grad_()
    out_t = perm_ops.collector_permute(xt, torch.from_numpy(perm))
    np.testing.assert_array_equal(_np(out_t), np.asarray(out_j, np.float32))
    # backward: the same gather with the inverse permutation
    w = rng.standard_normal(out_t.shape).astype(np.float32)
    wj, wt = _pair(w, dtype)
    gj = jax.grad(lambda z: jnp.sum(
        (j_permute_ad(z, jnp.asarray(perm), True) * wj).astype(jnp.float32))
    )(xj)
    (gt,) = torch.autograd.grad((out_t * wt).float().sum(), xt)
    np.testing.assert_array_equal(_np(gt), np.asarray(gj, np.float32))


def test_inverse_permutation_is_argsort():
    perm = torch.from_numpy(np.random.default_rng(3).permutation(50))
    np.testing.assert_array_equal(perm_ops.inverse_permutation(perm).numpy(),
                                  np.argsort(perm.numpy()))


# --------------------------------------------------------------------------
# K4a / K4b: the route plan's bucket gathers

def _index_map(rng, rows, perm):
    """A permutation (the dense plan) or a map with repeats and gaps (the
    slack-padded plan reuses filler rows)."""
    return (rng.permutation(rows) if perm
            else rng.integers(0, rows, rows)).astype(np.int32)


@pytest.mark.parametrize("sc,feat,perm,dtype", [
    ((2, 3), 16, True, "float32"), ((4, 4), 100, False, "bfloat16"),
    ((8, 2), 512, True, "bfloat16"), ((3, 7), 513, False, "float32"),
    ((3, 7), 513, True, "bfloat16"), ((4, 4), 16, False, "float32")])
def test_bucket_permute_plain_matches_pallas(sc, feat, perm, dtype):
    s, cap = sc
    rows = s * cap
    rng = np.random.default_rng(s * 131 + cap * 17 + feat)
    xj, xt = _pair(rng.standard_normal((rows, feat)).astype(np.float32),
                   dtype)
    idx = _index_map(rng, rows, perm).reshape(s, cap)
    out_j = j_bucket(xj, jnp.asarray(idx), interpret=True)
    out_t = perm_ops.bucket_gather(xt, torch.from_numpy(idx))
    assert out_t.dtype == xt.dtype and tuple(out_t.shape) == (rows, feat)
    np.testing.assert_array_equal(_np(out_t), np.asarray(out_j, np.float32))


@pytest.mark.parametrize("rows,b,feat,dtype", [
    (2, 1, 16, "float32"), (40, 33, 100, "bfloat16"), (17, 5, 513,
                                                       "float32"),
    (9, 16, 513, "bfloat16"), (33, 33, 16, "float32")])
def test_unbucket_permute_plain_matches_pallas(rows, b, feat, dtype):
    """Including B != R (the receive block holds the pad row, or more
    rows than one slab) and repeated indices."""
    rng = np.random.default_rng(rows * 7 + b + feat)
    xj, xt = _pair(rng.standard_normal((rows, feat)).astype(np.float32),
                   dtype)
    idx = rng.integers(0, rows, b).astype(np.int32)
    out_j = j_unbucket(xj, jnp.asarray(idx), interpret=True)
    out_t = perm_ops.unbucket_gather(xt, torch.from_numpy(idx))
    assert out_t.dtype == xt.dtype and tuple(out_t.shape) == (b, feat)
    np.testing.assert_array_equal(_np(out_t), np.asarray(out_j, np.float32))


@pytest.mark.parametrize("sc,feat,perm", [((2, 4), 16, True),
                                          ((4, 3), 129, False),
                                          ((8, 2), 16, False)])
def test_bucket_gather_grads_match_jax(sc, feat, perm):
    """The scatter-add backward of both gathers against ``jax.grad`` of
    the JAX ``_ad`` wrappers: repeats in the index map accumulate."""
    s, cap = sc
    rows = s * cap
    rng = np.random.default_rng(s * 37 + feat)
    x = rng.standard_normal((rows, feat)).astype(np.float32)
    w = rng.standard_normal((rows, feat)).astype(np.float32)
    flat = _index_map(rng, rows, perm)
    for j_ad, t_op, idx in (
            (j_bucket_ad, perm_ops.bucket_permute, flat.reshape(s, cap)),
            (j_unbucket_ad, perm_ops.unbucket_permute, flat)):
        gj = jax.grad(lambda z: jnp.sum(j_ad(z, jnp.asarray(idx), True)
                                        * w))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        (gt,) = torch.autograd.grad(
            (t_op(xt, torch.from_numpy(idx)) * torch.from_numpy(w)).sum(),
            xt)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                                   atol=1e-6)


# --------------------------------------------------------------------------
# K5a / K5b: the quantized wire's fused gathers

@pytest.mark.parametrize("sc,feat,perm,wire,dtype", [
    ((2, 3), 16, True, "int8", "float32"),
    ((4, 4), 100, False, "int8", "bfloat16"),
    ((8, 2), 512, True, "float8_e4m3", "float32"),
    ((3, 7), 513, False, "float8_e4m3", "bfloat16"),
    ((3, 7), 513, True, "int8", "float32"),
    ((4, 4), 16, True, "float8_e4m3", "bfloat16")])
def test_quant_bucket_permute_plain_matches_pallas(sc, feat, perm, wire,
                                                   dtype):
    """Quantized rows and f32 scales bit for bit, an all-zero row
    included; the packed payload carries the same bytes."""
    s, cap = sc
    rows = s * cap
    rng = np.random.default_rng(s * 101 + cap * 13 + feat)
    x = (rng.standard_normal((rows, feat)) * 3).astype(np.float32)
    x[1] = 0.0
    xj, xt = _pair(x, dtype)
    idx = _index_map(rng, rows, perm).reshape(s, cap)
    qj, sj = j_quant(xj, jnp.asarray(idx), wire_dtype=wire, interpret=True)
    qt, st = quant_ops.quant_bucket_permute(xt, torch.from_numpy(idx),
                                            wire_dtype=wire)
    assert qt.dtype == {"int8": torch.int8,
                        "float8_e4m3": torch.float8_e4m3fn}[wire]
    np.testing.assert_array_equal(qt.view(torch.uint8).numpy(),
                                  np.asarray(qj).view(np.uint8))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    packed = quant_ops.quant_bucket_permute_packed(
        xt, torch.from_numpy(idx), wire_dtype=wire)
    want = np.concatenate([np.asarray(qj).view(np.uint8), np.asarray(
        JW.pack_scales(sj, wire)).view(np.uint8)], axis=1)
    np.testing.assert_array_equal(packed.view(torch.uint8).numpy(), want)


@pytest.mark.parametrize("rows,b,feat,wire,out_dtype", [
    (2, 1, 16, "int8", "float32"), (40, 33, 100, "float8_e4m3", "bfloat16"),
    (17, 5, 513, "int8", "bfloat16"), (9, 16, 513, "float8_e4m3",
                                       "float32"),
    (33, 33, 16, "int8", "float32")])
def test_dequant_unbucket_permute_plain_matches_pallas(rows, b, feat, wire,
                                                       out_dtype):
    """Dequantized gathered rows bit for bit, from separate q and scales
    and from the packed payload (the pad row's zero scale included)."""
    rng = np.random.default_rng(rows * 11 + b + feat)
    x = (rng.standard_normal((rows, feat)) * 2).astype(np.float32)
    x[0] = 0.0
    qj, sj = JW.quantize_rows(jnp.asarray(x), wire)
    idx = rng.integers(0, rows, b).astype(np.int32)
    jd, td = DT[out_dtype]
    out_j = np.asarray(j_dequant(qj, sj, jnp.asarray(idx), out_dtype=jd,
                                 interpret=True).astype(jnp.float32))
    qt = torch.from_numpy(np.asarray(qj).view(np.uint8).copy()).view(
        {"int8": torch.int8, "float8_e4m3": torch.float8_e4m3fn}[wire])
    st = torch.from_numpy(np.asarray(sj).copy())
    out_t = quant_ops.dequant_unbucket_permute(qt, st, torch.from_numpy(idx),
                                               out_dtype=td)
    assert out_t.dtype == td and tuple(out_t.shape) == (b, feat)
    np.testing.assert_array_equal(_np(out_t), out_j)
    packed = torch.cat([qt, torch.from_numpy(np.asarray(
        JW.pack_scales(sj, wire)).view(np.uint8).copy()).view(qt.dtype)], 1)
    out_p = quant_ops.dequant_unbucket_permute_packed(
        packed, torch.from_numpy(idx), out_dtype=td)
    np.testing.assert_array_equal(_np(out_p), out_j)


@pytest.mark.parametrize("wire,tol", [("int8", 2e-2), ("float8_e4m3", 2e-1)])
def test_quant_roundtrip_error_bound_and_zero_rows(wire, tol):
    """Inside the wire grid's per-row error bound (relative to the row
    amax), and an all-zero row comes back exactly."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((12, 64)) * 5).astype(np.float32)
    x[3] = 0.0
    xt = torch.from_numpy(x)
    idx = torch.arange(12, dtype=torch.int32)
    q, s = quant_ops.quant_bucket_permute(xt, idx.reshape(4, 3),
                                          wire_dtype=wire)
    out = quant_ops.dequant_unbucket_permute(q, s, idx,
                                             out_dtype=torch.float32)
    amax = np.abs(x).max(axis=1, keepdims=True)
    assert (np.abs(out.numpy() - x) <= tol * amax).all()
    assert not out[3].any()


@pytest.mark.parametrize("sc,feat,perm,wire", [
    ((2, 4), 16, True, "int8"), ((4, 3), 129, False, "float8_e4m3"),
    ((8, 2), 16, False, "int8")])
def test_quant_roundtrip_grad_is_straight_through(sc, feat, perm, wire):
    """The round trip's gradient against ``jax.grad`` of
    ``quant_dequant_roundtrip_ad``: routed by the composed gather alone,
    scatter-adding on repeats."""
    s, cap = sc
    rows = s * cap
    rng = np.random.default_rng(s * 43 + feat)
    x = rng.standard_normal((rows, feat)).astype(np.float32)
    w = rng.standard_normal((rows, feat)).astype(np.float32)
    send = _index_map(rng, rows, perm).reshape(s, cap)
    recv = rng.permutation(rows).astype(np.int32)
    gj = jax.grad(lambda z: jnp.sum(j_roundtrip(
        z, jnp.asarray(send), jnp.asarray(recv), wire, True) * w))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = quant_ops.quant_dequant_roundtrip_ad(
        xt, torch.from_numpy(send), torch.from_numpy(recv), wire)
    (gt,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xt)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------------
# K2 bn_act

def _bn_inputs(rng, rows, c):
    x = rng.standard_normal((rows, c)).astype(np.float32)
    a = (rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32)
    b = (rng.standard_normal(c) * 0.5).astype(np.float32)
    return x, a, b


@pytest.mark.parametrize("rows,c,relu", [(1, 8, True), (17, 16, False),
                                         (33, 64, True), (300, 8, True),
                                         (5, 100, False)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_act_plain_matches_pallas(rows, c, relu, dtype):
    rng = np.random.default_rng(rows * 13 + c)
    x, a, b = _bn_inputs(rng, rows, c)
    xj, xt = _pair(x, dtype)
    out_j = np.asarray(j_bn_act(xj, jnp.asarray(a), jnp.asarray(b),
                                relu=relu, interpret=True), np.float32)
    xt.requires_grad_()
    at, bt = (torch.from_numpy(v).requires_grad_() for v in (a, b))
    out_t = bn_ops.bn_act(xt, at, bt, relu=relu)
    assert out_t.dtype == xt.dtype
    if dtype == "float32":
        np.testing.assert_allclose(_np(out_t), out_j, rtol=1e-6, atol=1e-6)
    else:       # at most 1 bf16 ulp apart
        ulp = np.abs(out_j) * 2.0 ** -7 + 1e-30
        assert (np.abs(_np(out_t) - out_j) <= ulp).all()
    # gradients to all three operands
    w = rng.standard_normal((rows, c)).astype(np.float32)
    gj = jax.grad(lambda *o: jnp.sum(j_bn_act(
        *o, relu=relu, interpret=True).astype(jnp.float32) * w),
        argnums=(0, 1, 2))(xj, jnp.asarray(a), jnp.asarray(b))
    gt = torch.autograd.grad((out_t.float() * torch.from_numpy(w)).sum(),
                             (xt, at, bt))
    tol = 1e-5 if dtype == "float32" else 2e-2
    for u, v in zip(gt, gj):
        assert u.dtype == (xt.dtype if u.shape == xt.shape else torch.float32)
        np.testing.assert_allclose(_np(u), np.asarray(v, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("c", [8, 16, 64])
def test_bn_act_group_axis_is_per_group_affine(c):
    """x (G, ..., C) with a, b (G, C): every group with its own affine, as
    the JAX package's vmap over clients."""
    rng = np.random.default_rng(c)
    g = 3
    x = rng.standard_normal((g, 2, 4, 4, c)).astype(np.float32)
    a = rng.uniform(0.5, 1.5, (g, c)).astype(np.float32)
    b = rng.standard_normal((g, c)).astype(np.float32)
    out_j = jax.vmap(lambda xx, aa, bb: j_bn_act(xx, aa, bb,
                                                 interpret=True))(x, a, b)
    out_t = bn_ops.bn_act(*(torch.from_numpy(v) for v in (x, a, b)))
    np.testing.assert_allclose(_np(out_t), np.asarray(out_j), rtol=1e-6,
                               atol=1e-6)


# --------------------------------------------------------------------------
# K3 softmax_xent

def _labels(rng, rows, v, ignore):
    lab = rng.integers(0, v, rows)
    if ignore == "some":
        lab[::3] = -100
    elif ignore == "all":
        lab[:] = -100
    return lab


@pytest.mark.parametrize("rows,v,ignore", [
    (1, 2, "none"), (37, 11, "some"), (40, 100, "none"), (33, 100, "some"),
    (9, 128, "all"), (25, 200, "some"),
    (4, 20000, "some")])    # wider than the port's one-block MAX_V
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent_plain_matches_pallas(rows, v, ignore, dtype):
    rng = np.random.default_rng(rows * 17 + v)
    xj, xt = _pair((rng.standard_normal((rows, v)) * 3).astype(np.float32),
                   dtype)
    lab = _labels(rng, rows, v, ignore)
    val_j, g_j = jax.value_and_grad(
        lambda z: j_xent(z, jnp.asarray(lab), interpret=True))(xj)
    xt.requires_grad_()
    val_t = xent_ops.softmax_xent(xt, torch.from_numpy(lab))
    (g_t,) = torch.autograd.grad(val_t, xt)
    assert val_t.dtype == torch.float32 and g_t.dtype == xt.dtype
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(float(val_t.detach()), float(val_j), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(_np(g_t), np.asarray(g_j, np.float32),
                               rtol=tol, atol=tol)
    if ignore == "all":
        assert float(val_t.detach()) == 0.0 and not g_t.float().abs().any()


# --------------------------------------------------------------------------
# K6 rmsnorm

@pytest.mark.parametrize("shape,offset", [((1, 8), 0.0), ((33, 100), 1.0),
                                          ((7, 300), 0.0), ((12, 128), 1.0),
                                          ((3, 5, 256), 0.0)])
def test_rmsnorm_plain_matches_pallas(shape, offset):
    rng = np.random.default_rng(shape[0] * 7 + shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(shape[-1]) * 0.1 + 1.0).astype(np.float32)
    want = j_rmsnorm(jnp.asarray(x), jnp.asarray(scale), scale_offset=offset,
                     interpret=True)
    got = rms_ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale),
                          scale_offset=offset)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rmsnorm_bf16_3d_matches_pallas():
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng.standard_normal((4, 7, 96)).astype(np.float32),
                   "bfloat16")
    want = j_rmsnorm(xj, jnp.ones((96,)), interpret=True)
    got = rms_ops.rmsnorm(xt, torch.ones(96))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


# --------------------------------------------------------------------------
# K7 flash attention

FLASH_SHAPES = [  # (b, s, (h, k), d, causal, window): the fuzz ranges
    (1, 16, (4, 2), 32, True, None), (2, 64, (4, 4), 64, False, None),
    (1, 100, (8, 1), 32, True, 16), (2, 128, (4, 2), 64, True, None),
    (1, 100, (4, 4), 64, False, 16), (2, 16, (8, 1), 64, False, None),
    # head_dim 256 (gemma-7b MHA, recurrentgemma-9b MQA with a window)
    (1, 64, (4, 4), 256, True, None), (1, 48, (4, 1), 256, True, 16),
    (2, 32, (2, 1), 256, False, None), (1, 40, (2, 2), 256, False, 8)]


@pytest.mark.parametrize("b,s,hk,d,causal,window", FLASH_SHAPES)
def test_flash_attention_plain_matches_jax(b, s, hk, d, causal, window):
    """The port's plain version against the JAX oracle (1e-5) and the
    Pallas kernel in interpret mode (2e-3); on CPU tensors the wrapper
    (the kernel impl of the attention layer) is the plain version."""
    h, k = hk
    rng = np.random.default_rng(b * 1000 + s + d)
    q, kk, v = (rng.standard_normal((b, s, n, d)).astype(np.float32)
                for n in (h, k, k))
    jq, jk, jv = map(jnp.asarray, (q, kk, v))
    tq, tk, tv = map(torch.from_numpy, (q, kk, v))
    ref_t = flash_ref.attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(
        _np(ref_t), np.asarray(j_attn_ref(jq, jk, jv, causal=causal,
                                          window=window)),
        rtol=1e-5, atol=1e-5)
    got = flash_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert torch.equal(got, ref_t)
    np.testing.assert_allclose(
        _np(got), np.asarray(j_flash(jq, jk, jv, causal=causal,
                                     window=window, interpret=True)),
        rtol=2e-3, atol=2e-3)


def test_flash_attention_bf16_matches_pallas():
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal((2, 64, n, 32)).astype(np.float32),
              "bfloat16") for n in (4, 2, 2))
    want = j_flash(jq, jk, jv, causal=True, interpret=True)
    got = flash_ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_forward_only_kernels_refuse_a_gradient():
    """The JAX package defines no VJP for K6 or K7; neither wrapper
    differentiates."""
    x = torch.randn(2, 8, 4, 32, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no VJP"):
        flash_ops.flash_attention(x, x[:, :, :2], x[:, :, :2]).sum().backward()
    with pytest.raises(NotImplementedError, match="no VJP"):
        rms_ops.rmsnorm(x, torch.ones(32)).sum().backward()


# --------------------------------------------------------------------------
# gradcheck of every autograd.Function in float64 on the plain path

def test_gradcheck_collector_permute():
    x = torch.randn(6, 3, 2, dtype=torch.float64, requires_grad=True)
    perm = torch.randperm(6)
    assert torch.autograd.gradcheck(
        lambda z: perm_ops.collector_permute(z, perm), (x,))


@pytest.mark.parametrize("relu", [True, False])
def test_gradcheck_bn_act(relu):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 5, 4, dtype=torch.float64, generator=g)
    x = (x + 0.05 * torch.sign(x)).requires_grad_()   # keep off relu's kink
    a = (torch.rand(2, 4, dtype=torch.float64, generator=g) + 0.5
         ).requires_grad_()
    b = (0.01 * torch.randn(2, 4, dtype=torch.float64, generator=g)
         ).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda *o: bn_ops.bn_act(*o, relu=relu), (x, a, b))


def test_gradcheck_softmax_xent():
    x = torch.randn(7, 5, dtype=torch.float64, requires_grad=True)
    lab = torch.tensor([0, 4, -100, 2, 1, -100, 3])
    assert torch.autograd.gradcheck(
        lambda z: xent_ops.softmax_xent(z, lab), (x,))


@pytest.mark.parametrize("which", ["bucket", "unbucket"])
def test_gradcheck_bucket_gathers(which):
    g = torch.Generator().manual_seed(1)
    x = torch.randn(6, 3, dtype=torch.float64, generator=g,
                    requires_grad=True)
    idx = torch.tensor([[0, 3, 3], [5, 1, 0]], dtype=torch.int32)
    op = perm_ops.bucket_permute if which == "bucket" else \
        perm_ops.unbucket_permute
    if which == "unbucket":
        idx = idx.reshape(-1)
    assert torch.autograd.gradcheck(lambda z: op(z, idx), (x,))
