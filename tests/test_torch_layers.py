"""The port's layers against the JAX package's on the same inputs (CPU).

Inputs are made with numpy from a seed and fed to both sides; JAX conv
kernels cross over through ``repro_torch.convert``. Tolerance: f32 atol and
rtol 1e-5 (the reference's own f32 bound, tests/test_submesh.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import conv as jconv, linear as jlin, norm as jnorm
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.nn import conv as tconv, linear as tlin, norm as tnorm
from repro_torch.nn import init as tinit

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("hw,stride,k,cin,cout", [
    (8, 1, 3, 3, 8), (8, 2, 3, 8, 16), (7, 2, 3, 4, 8), (9, 1, 3, 2, 4),
    (8, 2, 1, 8, 16), (7, 2, 1, 4, 4)])
def test_conv_same_padding_matches_jax(hw, stride, k, cin, cout):
    rng = np.random.default_rng(hw * 10 + stride + k)
    x = rng.standard_normal((2, hw, hw, cin)).astype(np.float32)
    p = {"w": rng.standard_normal((k, k, cin, cout)).astype(np.float32)}
    yj = jconv.conv2d_apply(p, jnp.asarray(x), stride=stride)
    yt = tconv.conv2d_apply(from_jax_numpy(p), torch.from_numpy(x),
                            stride=stride)
    assert tuple(yt.shape) == yj.shape
    _close(yt, yj)


@pytest.mark.parametrize("stride", [1, 2])
def test_client_stacked_conv_is_per_client_conv(stride):
    """The grouped conv over a leading client axis equals each client's
    own conv (the JAX package's vmap)."""
    rng = np.random.default_rng(stride)
    n = 3
    x = rng.standard_normal((n, 2, 8, 8, 3)).astype(np.float32)
    p = {"w": rng.standard_normal((n, 3, 3, 3, 4)).astype(np.float32)}
    yj = jax.vmap(lambda pp, xx: jconv.conv2d_apply(pp, xx, stride=stride))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    yt = tconv.conv2d_apply(from_jax_numpy(p), torch.from_numpy(x),
                            stride=stride)
    _close(yt, yj)


def test_dense_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 16)).astype(np.float32)
    p = {"w": rng.standard_normal((16, 10)).astype(np.float32),
         "b": rng.standard_normal((10,)).astype(np.float32)}
    _close(tlin.dense_apply(from_jax_numpy(p), torch.from_numpy(x)),
           jlin.dense_apply(p, jnp.asarray(x)))


def _bn_inputs(seed, shape, c):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.standard_normal(c).astype(np.float32)}
    s = {"mean": rng.standard_normal(c).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, c).astype(np.float32),
         "count": np.float32(3.0)}
    return x, p, s


@pytest.mark.parametrize("training,rmsd,masked", [
    (True, None, False), (True, None, True), (False, True, False),
    (False, False, False), (False, False, True)])
@pytest.mark.parametrize("fused", [False, True])
def test_batchnorm_matches_jax(training, rmsd, masked, fused):
    """Training update (biased variance, momentum 0.9, count), RMSD and
    CMSD inference, and the valid-row mask, unfused and folded."""
    x, p, s = _bn_inputs(1, (6, 4, 4, 8), 8)
    valid = np.array([1, 0, 1, 1, 0, 1], bool) if masked else None
    fj = jnorm.batchnorm_act_apply if fused else jnorm.batchnorm_apply
    ft = tnorm.batchnorm_act_apply if fused else tnorm.batchnorm_apply
    kw = {"relu": True} if fused else {}
    yj, sj = fj(p, s, jnp.asarray(x), training=training,
                use_running_stats=rmsd,
                valid=None if valid is None else jnp.asarray(valid), **kw)
    yt, st = ft(from_jax_numpy(p), from_jax_numpy(s), torch.from_numpy(x),
                training=training, use_running_stats=rmsd,
                valid=None if valid is None else torch.from_numpy(valid),
                **kw)
    _close(yt, yj)
    for k in ("mean", "var", "count"):
        _close(st[k], sj[k])


def test_client_stacked_batchnorm_is_per_client():
    """Stacked BN params normalize every client with its own moments."""
    n = 3
    x, p, s = _bn_inputs(2, (n, 2, 4, 4, 8), 8)
    ps = {k: np.stack([v * (i + 1) for i in range(n)]) for k, v in p.items()}
    ss = {k: np.stack([v] * n) for k, v in s.items()}
    yj, sj = jax.vmap(lambda pp, sv, xx: jnorm.batchnorm_act_apply(
        pp, sv, xx, training=True))(ps, ss, jnp.asarray(x))
    yt, st = tnorm.batchnorm_act_apply(from_jax_numpy(ps), from_jax_numpy(ss),
                                       torch.from_numpy(x), training=True)
    _close(yt, yj)
    for k in ("mean", "var", "count"):
        _close(st[k], sj[k])


def test_init_fans_and_scales():
    """Same fan rules as the JAX package; the draws differ, the scale does
    not."""
    from repro.nn.init import _fans as jfans
    for shape, axes in (((3, 3, 16, 32), (2, 3)), ((64, 10), (-2, -1)),
                        ((5,), (-2, -1))):
        assert tinit._fans(shape, *axes) == jfans(shape, *axes)
    g = torch.Generator().manual_seed(0)
    w = tinit.he_normal(g, (3, 3, 64, 64), in_axis=2, out_axis=3)
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * 64))) < 0.01
    p = tconv.conv2d_init(g, 3, 16, 3)
    assert tuple(p["w"].shape) == (16, 3, 3, 3)
    assert np.asarray(to_numpy(p)["w"]).shape == (3, 3, 3, 16)


def test_schedules_and_accuracy_match_jax():
    from repro.models.common import accuracy_from_logits as j_acc
    from repro.optim import schedule as jsched
    from repro_torch.models.common import accuracy_from_logits as t_acc
    from repro_torch.optim import schedule as tsched
    pairs = [(jsched.constant_lr(0.1), tsched.constant_lr(0.1)),
             (jsched.multistep_lr(0.1, [3, 6], 0.02),
              tsched.multistep_lr(0.1, [3, 6], 0.02)),
             (jsched.cosine_lr(0.1, 10, warmup=2),
              tsched.cosine_lr(0.1, 10, warmup=2))]
    for fj, ft in pairs:
        for step in (0, 1, 3, 5, 6, 9, 12):
            np.testing.assert_allclose(ft(step), float(fj(step)), rtol=1e-6)
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((9, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 9)
    labels[::4] = -100
    np.testing.assert_allclose(
        float(t_acc(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(j_acc(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
