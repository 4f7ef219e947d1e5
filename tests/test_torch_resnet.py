"""The port's split ResNet against the JAX package's on the same params.

Params and BN state come from the JAX ``R.init`` and cross over through
``repro_torch.convert``; inputs are numpy from a seed. Logits, new BN
state and the gradients of every parameter are compared. Tolerances:
<= 1e-5 with ``policy=None``; for ``ComputePolicy("bfloat16")`` loss
<= 1e-2 and grads <= 8e-2 (the bounds of tests/test_compute_policy.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import resnet as JR
from repro.models.common import ComputePolicy as JPolicy
from repro.models.common import softmax_cross_entropy as j_xent
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.models import resnet as TR
from repro_torch.models.common import ComputePolicy as TPolicy
from repro_torch.models.common import softmax_cross_entropy as t_xent
from repro_torch.tree import grads, with_grad

V, B, HW = 8, 4, 8
CFG_J = JR.ResNetConfig(depth=8, num_classes=V, width=8)
CFG_T = TR.ResNetConfig(depth=8, num_classes=V, width=8)


@pytest.fixture(scope="module")
def setup():
    p, s = jax.jit(JR.init, static_argnums=1)(jax.random.PRNGKey(0), CFG_J)
    p, s = (jax.tree_util.tree_map(np.asarray, t) for t in (p, s))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, HW, HW, 3)).astype(np.float32)
    y = rng.integers(0, V, B).astype(np.int32)
    return p, s, x, y


def _flat(tree):
    return jax.tree_util.tree_leaves(tree)


def _assert_trees(t_tree, j_tree, tol):
    a, b = _flat(to_numpy(t_tree)), _flat(jax.tree_util.tree_map(
        np.asarray, j_tree))
    assert len(a) == len(b)
    for u, v in zip(a, b):
        np.testing.assert_allclose(np.asarray(u, np.float32),
                                   np.asarray(v, np.float32), rtol=tol,
                                   atol=tol)


def test_client_and_server_apply_match_jax(setup):
    p, s, x, _ = setup
    a_j, cs_j = jax.jit(JR.client_apply)(p["client"], s["client"],
                                         jnp.asarray(x))
    pt, st = from_jax_numpy(p), from_jax_numpy(s)
    a_t, cs_t = TR.client_apply(pt["client"], st["client"],
                                torch.from_numpy(x))
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=1e-5,
                               atol=1e-5)
    _assert_trees(cs_t, cs_j, 1e-5)
    valid = np.array([True, False, True, True])
    for v in (None, valid):
        l_j, ss_j = jax.jit(
            lambda sp, ss, a, vv: JR.server_apply(sp, ss, a, CFG_J,
                                                  valid=vv))(
            p["server"], s["server"], a_j,
            None if v is None else jnp.asarray(v))
        l_t, ss_t = TR.server_apply(pt["server"], st["server"], a_t, CFG_T,
                                    valid=None if v is None
                                    else torch.from_numpy(v))
        np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), rtol=1e-5,
                                   atol=1e-5)
        _assert_trees(ss_t, ss_j, 1e-5)


@pytest.mark.parametrize("training,rmsd", [(True, None), (False, True),
                                           (False, False)])
def test_apply_and_grads_match_jax_f32(setup, training, rmsd):
    p, s, x, y = setup

    def jloss(pp):
        logits, ns = JR.apply(pp, s, jnp.asarray(x), CFG_J,
                              training=training, rmsd=rmsd)
        return j_xent(logits, jnp.asarray(y)), (logits, ns)
    (lj, (logits_j, ns_j)), gj = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(p)

    pt = with_grad(from_jax_numpy(p))
    logits_t, ns_t = TR.apply(pt, from_jax_numpy(s), torch.from_numpy(x),
                              CFG_T, training=training, rmsd=rmsd)
    lt = t_xent(logits_t, torch.from_numpy(y))
    gt = grads(lt, pt)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(logits_t.detach().numpy(),
                               np.asarray(logits_j), rtol=1e-5, atol=1e-5)
    _assert_trees(ns_t, ns_j, 1e-5)
    _assert_trees(gt, gj, 1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_bf16_policy_matches_jax(setup, fused):
    """bf16 compute: JAX with its Pallas kernels in interpret mode (or its
    plain fused path) against the port's plain versions."""
    p, s, x, y = setup
    jpol = JPolicy("bfloat16", use_fused_kernels=fused,
                   kernel_interpret=True)
    tpol = TPolicy("bfloat16", use_fused_kernels=fused)

    def jloss(pp):
        logits, _ = JR.apply(pp, s, jnp.asarray(x), CFG_J, policy=jpol)
        return j_xent(logits, jnp.asarray(y))
    lj, gj = jax.jit(jax.value_and_grad(jloss))(p)

    pt = with_grad(from_jax_numpy(p))
    logits_t, _ = TR.apply(pt, from_jax_numpy(s), torch.from_numpy(x),
                           CFG_T, policy=tpol)
    assert logits_t.dtype == torch.bfloat16
    lt = t_xent(logits_t, torch.from_numpy(y))
    gt = grads(lt, pt)
    assert all(g.dtype == torch.float32 for g in _flat(gt))
    assert abs(float(lt.detach()) - float(lj)) <= 1e-2
    _assert_trees(gt, gj, 8e-2)
