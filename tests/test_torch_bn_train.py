"""The BatchNorm training op (``kernels/bn_act/ops.py::bn_train``) on the
CPU, where it runs its plain version (``kernels/bn_act/ref.py``), against
the autograd chain it replaces (``batchnorm_act_apply(use_kernel=False)``):
the output and the running state bitwise, the gradients of x, scale and
bias within the rounding of one bf16 store (f32: 1e-5 of the largest);
a float64 ``gradcheck`` of the plain path; which calls take the op; and
the kernels' launch geometry. The op is held against the JAX package's
BatchNorm too (``repro.nn.norm.batchnorm_act_apply`` and ``jax.grad``, the
client-stacked form through ``jax.vmap``), which the CPU's other JAX
parity tests do not reach: there ``batchnorm_act_apply`` keeps its plain
chain. The kernels themselves are held against the plain version on the
card (``tests/test_torch_cuda.py``).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import norm as jnorm
from repro_torch.kernels.bn_act import kernel as bn_k, ops as bn_ops
from repro_torch.nn import norm


def _inputs(seed, groups, dtype, c=8):
    g = torch.Generator().manual_seed(seed)
    shape = (4, 5, 5, c) if groups == 1 else (groups, 4, 5, 5, c)
    pc = (c,) if groups == 1 else (groups, c)
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    p = {"scale": torch.rand(pc, generator=g) + 0.5,
         "bias": torch.randn(pc, generator=g)}
    s = {"mean": torch.randn(pc, generator=g),
         "var": torch.rand(pc, generator=g) + 0.5,
         "count": torch.full(() if groups == 1 else (groups,), 3.0)}
    gy = torch.randn(shape, generator=g).to(dtype)
    return x, p, s, gy


def _run(fn, x, p, gy):
    x = x.clone().requires_grad_()
    p = {k: v.clone().requires_grad_() for k, v in p.items()}
    y, new = fn(x, p)
    (y.float() * gy.float()).sum().backward()
    return y.detach(), new, x.grad, p["scale"].grad, p["bias"].grad


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_op_matches_the_autograd_chain(groups, relu, dtype):
    x, p, s, gy = _inputs(groups + 10 * relu, groups, dtype)
    old = _run(lambda x, p: norm.batchnorm_act_apply(
        p, s, x, training=True, relu=relu, use_kernel=False), x, p, gy)
    new = _run(lambda x, p: bn_ops.bn_train(
        x, p["scale"], p["bias"], s["mean"], s["var"], s["count"],
        training=True, relu=relu), x, p, gy)
    assert torch.equal(old[0], new[0])
    for key, got in zip(("mean", "var", "count"), new[1]):
        assert got.shape == s[key].shape
        assert torch.equal(old[1][key], got), key
    # dx: one bf16 rounding where the chain added two rounded halves
    tol = torch.finfo(dtype).eps * float(old[2].float().abs().max())
    assert float((old[2].float() - new[2].float()).abs().max()) <= tol
    for want, got in zip(old[3:], new[3:]):
        assert torch.allclose(got, want, rtol=1e-5,
                              atol=1e-5 * float(want.abs().max()))


def _jax(t):
    a = jnp.asarray(t.float().numpy())
    return a.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else a


def _f32(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _within(got, want, rel, scale):
    """|got - want| <= rel * (|want| + max |want|) elementwise."""
    got, want = got.float(), _f32(want)
    lim = rel * (want.abs() + float(want.abs().max()) * scale)
    assert bool(((got - want).abs() <= lim).all()), float(
        (got - want).abs().max())


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("training", [True, False])     # False: CMSD
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_op_matches_jax(groups, relu, training, dtype):
    """The op's output, running state and gradients of x, scale and bias
    against the JAX package's BatchNorm on the same inputs: the output and
    dx within one bf16 rounding (of the largest) at bf16, within the 1e-5
    of the other JAX parity tests at f32; the state and dscale, dbias
    within 1e-5 (the two take their sums in other orders)."""
    x, p, s, gy = _inputs(20 + groups + 2 * relu, groups, dtype)

    def jbn(pp, ss, xx):
        return jnorm.batchnorm_act_apply(pp, ss, xx, training=training,
                                         relu=relu, use_running_stats=False)

    jbn = jax.vmap(jbn) if groups > 1 else jbn
    pj = {k: _jax(v) for k, v in p.items()}
    sj = {k: _jax(v) for k, v in s.items()}
    xj, gj = _jax(x), _jax(gy.float())

    def loss(xx, pp):
        return jnp.sum(jbn(pp, sj, xx)[0].astype(jnp.float32) * gj)

    yj, new_j = jbn(pj, sj, xj)
    dxj, dpj = jax.grad(loss, argnums=(0, 1))(xj, pj)
    y, new, dx, dscale, dbias = _run(lambda x, p: bn_ops.bn_train(
        x, p["scale"], p["bias"], s["mean"], s["var"], s["count"],
        training=training, relu=relu), x, p, gy)
    one = max(torch.finfo(dtype).eps, 1e-5)
    _within(y, yj, one, 1.0)
    _within(dx, dxj, one, 1.0)
    _within(dscale, dpj["scale"], 1e-5, 1.0)
    _within(dbias, dpj["bias"], 1e-5, 1.0)
    if not training:
        assert new is None
        return
    for key, got in zip(("mean", "var"), new):
        _within(got, new_j[key], 1e-5, 1.0)
    assert torch.equal(new[2], _f32(new_j["count"]).reshape(new[2].shape))


@pytest.mark.parametrize("groups", [1, 3])
def test_cmsd_call_keeps_the_state(groups):
    x, p, s, _ = _inputs(5, groups, torch.bfloat16)
    want, st = norm.batchnorm_act_apply(p, s, x, training=False,
                                        use_running_stats=False)
    got, new = bn_ops.bn_train(x, p["scale"], p["bias"], s["mean"],
                               s["var"], s["count"], training=False)
    assert new is None and st is s
    assert torch.equal(got, want)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("relu", [True, False])
def test_plain_path_gradcheck_float64(groups, relu):
    x, p, s, _ = _inputs(7, groups, torch.float64, c=3)
    x = x[..., :2, :2, :].contiguous().requires_grad_()
    scale = p["scale"].double().requires_grad_()
    bias = p["bias"].double().requires_grad_()

    def f(x, scale, bias):
        return bn_ops.bn_train(x, scale, bias, s["mean"], s["var"],
                               s["count"], training=True, relu=relu)[0]

    assert torch.autograd.gradcheck(f, (x, scale, bias))


def _cuda_like():
    return types.SimpleNamespace(is_cuda=True)


@pytest.mark.parametrize("kw,takes", [
    (dict(training=True), True),
    (dict(training=False, use_running_stats=False), True),      # CMSD
    (dict(training=False), False),                              # RMSD
    (dict(training=False, use_running_stats=True), False),
    (dict(training=True, valid=torch.ones(4, dtype=torch.bool)), False),
    (dict(training=True, reduce=lambda t: t), False),
    (dict(training=True, use_kernel=False), False),
])
def test_which_calls_take_the_train_op(kw, takes):
    args = dict(use_kernel=True, use_running_stats=None, valid=None,
                reduce=None) | kw
    assert norm._takes_train_op(_cuda_like(), **args) is takes
    assert norm._takes_train_op(torch.zeros(1), **args) is False


def test_valid_and_reduce_keep_the_plain_code(monkeypatch):
    """Taken as a CUDA call, one with a row mask or a sum over ranks still
    runs the plain code, to the bit; one with neither reaches the op."""
    x, p, s, _ = _inputs(3, 1, torch.float32)
    extras = (dict(valid=torch.tensor([True, True, False, True])),
              dict(reduce=lambda t: t))
    wants = [norm.batchnorm_act_apply(p, s, x, training=True, **e)
             for e in extras]
    real = norm._takes_train_op
    monkeypatch.setattr(norm, "_takes_train_op",
                        lambda x, **kw: real(_cuda_like(), **kw))
    called = []
    monkeypatch.setattr(bn_ops, "bn_train",
                        lambda *a, **kw: called.append(1) or (a[0], None))
    for extra, want in zip(extras, wants):
        got = norm.batchnorm_act_apply(p, s, x, training=True,
                                       use_kernel=True, **extra)
        assert torch.equal(got[0], want[0])
        for key in ("mean", "var", "count"):
            assert torch.equal(got[1][key], want[1][key])
    assert not called
    norm.batchnorm_act_apply(p, s, x, training=True, use_kernel=True)
    assert called == [1]


@pytest.mark.parametrize("groups,rows,c,elem,aligned,vec,tile,parts", [
    (1, 12800 * 1024, 16, 2, True, 8, 128, 528),     # r56 stage 1
    (1, 12800 * 64, 64, 2, True, 8, 32, 528),        # r56 stage 3
    (100, 128 * 1024, 16, 2, True, 8, 128, 5),       # r56 clients
    (10, 128 * 1024, 16, 2, True, 8, 128, 52),       # r32 clients
    (1, 1280 * 64, 64, 2, True, 8, 32, 160),         # r32 stage 3
    (1, 37, 16, 2, False, 1, 16, 1),                 # unaligned
    (3, 1001, 5, 4, True, 1, 51, 2),                 # C not a vector
    (2, 7, 24, 4, True, 4, 42, 1),                   # one tile
])
def test_stat_geometry(groups, rows, c, elem, aligned, vec, tile, parts):
    got = bn_k.stat_geometry(groups, rows, c, elem, aligned, 132)
    assert got[:3] == (vec, tile, parts)
    assert tile * (c // vec) <= bn_k.STAT_THREADS
    tiles = -(-rows // tile)
    assert 1 <= got[2] <= -(-tiles // bn_k.MIN_TILES)
    assert 1 <= got[3] <= tiles
    assert groups * got[2] <= max(groups, bn_k.BLOCKS_PER_SM * 132)


def test_stat_geometry_refuses_too_many_channels():
    with pytest.raises(ValueError, match="channels"):
        bn_k.stat_geometry(1, 10, 257, 4, False, 132)
