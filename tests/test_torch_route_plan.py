"""The port's route plans and permutation functions against the JAX
package's ``repro.core.collector_dist``.

Plans are built by both packages from the same permutation and must be
EQUAL: ``send_idx``, ``recv_idx`` and ``overflow``, for balanced perms at
the exact capacity, grouped-balanced perms at alpha 0.5, uniform perms in
slack buffers, and a perm forced to overflow. The host-side sizing
(``exact_pair_cap``, ``uniform_auto_slack``, ``pair_capacity``,
``grouped_perm_slack``, ``pair_load``) must return the same numbers. The
port's own balanced and grouped permutations (drawn from a
``torch.Generator``) are checked with hypothesis to be permutations that
stay inside their flush groups with every (src, dst) pair load exactly
the dense capacity.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import collector_dist as JCD
from repro_torch.core import collector as TC
from repro_torch.core import collector_dist as TCD


def _np(t):
    return None if t is None else np.asarray(t)


def _assert_plans_equal(perm, n_shards, cap, may_drop):
    jf, jb = JCD.build_route_plans(jnp.asarray(perm, jnp.int32), n_shards,
                                   cap=cap, may_drop=may_drop)
    tf, tb = TCD.build_route_plans(torch.from_numpy(np.asarray(perm)),
                                   n_shards, cap=cap, may_drop=may_drop)
    for j, t in ((jf, tf), (jb, tb)):
        assert t.send_idx.dtype == torch.int32
        np.testing.assert_array_equal(t.send_idx.numpy(), _np(j.send_idx))
        np.testing.assert_array_equal(t.recv_idx.numpy(), _np(j.recv_idx))
        if j.overflow is None:
            assert t.overflow is None
        else:
            assert int(t.overflow) == int(j.overflow)
        assert (t.n, t.n_shards, t.cap, t.may_drop, t.dense) == (
            j.n, j.n_shards, j.cap, j.may_drop, j.dense)
    return tf


@pytest.mark.parametrize("n,s", [(64, 8), (64, 4), (32, 2), (16, 1)])
def test_balanced_plans_equal_jax(n, s):
    perm = np.asarray(TCD.make_balanced_perm(torch.Generator().manual_seed(n
                                                                      + s),
                                             n, s))
    plan = _assert_plans_equal(perm, s, TCD.exact_pair_cap(n, s), False)
    assert plan.dense


@pytest.mark.parametrize("n,s,clients", [(64, 4, 8), (64, 2, 8),
                                         (128, 8, 16)])
def test_grouped_plans_equal_jax(n, s, clients):
    rows = [c * (n // clients) for c in TC.flush_group_sizes(clients, 0.5)]
    perm = np.asarray(TCD.make_grouped_balanced_perm(
        torch.Generator().manual_seed(s), n, s, rows))
    _assert_plans_equal(perm, s, TCD.exact_pair_cap(n, s, rows), False)
    _assert_plans_equal(perm, s, TCD.exact_pair_cap(n, s, rows), True)


@pytest.mark.parametrize("n,s,alpha", [(64, 8, 1.0), (64, 4, 0.5),
                                       (80, 4, 1.0)])
def test_uniform_plans_equal_jax(n, s, alpha):
    clients = 8
    rows = [c * (n // clients) for c in TC.flush_group_sizes(clients, alpha)]
    slack = TCD.uniform_auto_slack(n, s, rows if len(rows) > 1 else None)
    cap = TCD.pair_capacity(n, s, slack)
    perm = np.asarray(TC.make_flush_perm(torch.Generator().manual_seed(n),
                                         n, clients, alpha))
    plan = _assert_plans_equal(perm, s, cap, True)
    assert plan.may_drop and int(plan.overflow) == 0


def test_forced_overflow_plan_equals_jax():
    """The rolled perm sends all 8 rows of each slab to one destination
    against capacity 2: 6 rows per slab overflow, in both plans alike, and
    no overflowing row takes an in-capacity slot."""
    n, s = 64, 8
    perm = np.roll(np.arange(n), -8)
    cap = TCD.pair_capacity(n, s, 1.0)
    assert cap == 2
    plan = _assert_plans_equal(perm, s, cap, True)
    assert int(plan.overflow) == 8 * 6
    drop = s * cap                                # the zero pad row
    assert int((plan.recv_idx == drop).sum()) == 8 * 6


def test_inverse_and_loads_equal_jax():
    perm = np.random.default_rng(0).permutation(48)
    np.testing.assert_array_equal(
        TCD.inverse_permutation_scatter(torch.from_numpy(perm)).numpy(),
        np.asarray(JCD.inverse_permutation_scatter(jnp.asarray(perm))))
    for s in (1, 2, 4, 8):
        np.testing.assert_array_equal(TCD.pair_load(perm, s),
                                      JCD.pair_load(perm, s))
        assert TCD.max_pair_load(perm, s) == JCD.max_pair_load(perm, s)
    with pytest.raises(ValueError, match="would drop rows"):
        TCD.assert_pair_capacity(np.roll(np.arange(64), -8), 8, slack=1.0)


@pytest.mark.parametrize("n,s,rows", [
    (64, 8, None), (64, 8, [32, 32]), (64, 8, [16, 16, 16, 16]),
    (64, 2, [32, 32]), (64, 4, [8] * 8), (800, 1, None), (96, 4, [48, 48])])
def test_sizing_equals_jax(n, s, rows):
    assert TCD.exact_pair_cap(n, s, rows) == JCD.exact_pair_cap(n, s, rows)
    assert TCD.uniform_auto_slack(n, s, rows) == \
        JCD.uniform_auto_slack(n, s, rows)
    for slack in (1.0, 1.5, TCD.uniform_auto_slack(n, s, rows)):
        assert TCD.pair_capacity(n, s, slack) == \
            JCD.pair_capacity(n, s, slack)
    if rows is not None:
        assert TCD.grouped_perm_slack(n, s, rows) == \
            JCD.grouped_perm_slack(n, s, rows)


@settings(max_examples=25, deadline=None)
@given(s=st.sampled_from([1, 2, 4]), per_shard_blocks=st.integers(1, 3),
       alpha=st.sampled_from([1.0, 0.5, 0.25]), seed=st.integers(0, 999))
def test_port_balanced_perms_keep_exact_pair_loads(s, per_shard_blocks,
                                                   alpha, seed):
    """A permutation of the pool, inside every flush group, with every
    (src, dst) load at most the dense capacity, reached on every pair
    that the group structure routes."""
    clients_per_shard = 2
    clients = s * clients_per_shard
    batch = s * per_shard_blocks
    n = clients * batch
    rows = [c * batch for c in TC.flush_group_sizes(clients, alpha)]
    b = n // s
    if any(not any(TCD.group_fits_slabs(sum(rows[:i]), r, b))
           for i, r in enumerate(rows)):
        return                                    # layout check rejects it
    if any(r % b == 0 and r // b > 1 and b % (r // b) for r in rows):
        return
    perm = TCD.make_grouped_balanced_perm(torch.Generator().manual_seed(seed),
                                          n, s, rows).numpy()
    assert sorted(perm.tolist()) == list(range(n))
    start = 0
    for r in rows:
        assert set(perm[start:start + r].tolist()) == set(range(start,
                                                                 start + r))
        start += r
    load = TCD.pair_load(perm, s)
    cap = TCD.exact_pair_cap(n, s, rows)
    assert load.max() == cap
    if len(rows) == 1:
        assert (load == b // s).all()             # balanced: every pair
