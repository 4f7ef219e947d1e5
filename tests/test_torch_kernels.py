"""Each kernel's plain PyTorch version against the JAX Pallas kernel.

The Pallas kernels run in interpret mode on the CPU, as tests/test_kernels.py
runs them; the port's wrappers, given CPU tensors, run their plain
versions. Inputs are made with numpy from a seed; bf16 inputs are rounded
to bf16 identically on both sides. Tolerances: permute bitwise; bn_act
1e-6 in f32 and 1 bf16 ulp; softmax_xent value and logits-grad 1e-5 in f32
and 1e-2 in bf16. Each ``autograd.Function`` also passes
``torch.autograd.gradcheck`` in float64 on the plain path.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bn_act.ops import bn_act as j_bn_act
from repro.kernels.collector_permute.ops import (
    collector_permute as j_permute, collector_permute_ad as j_permute_ad)
from repro.kernels.softmax_xent.ops import softmax_xent as j_xent
from repro_torch.kernels.bn_act import ops as bn_ops
from repro_torch.kernels.collector_permute import ops as perm_ops
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
    (9, 128, "all"), (25, 200, "some")])
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
