"""The port's fault-tolerance pieces against the JAX package's, on one
process (CPU):

  1. ``core.retry``: backoff schedules (equal to JAX's for the same
     arguments), the injectable clock, the ``RetryError`` budget;
  2. ``core.faults``: ``FaultPlan`` draws equal to JAX's bit for bit over
     a grid of seeds, epochs, rates and straggler policies; purity, the
     kill schedule, ``ensure_group_survivor``;
  3. ``checkpoint.npz``: atomic writes with no temp litter, ``ValueError``
     on a missing leaf or a wrong shape, the train-state round trip with
     the generator's state; a JAX-written train state carried into the
     port bitwise and continued for one masked epoch against JAX's
     (<= 1e-5, the reference's f32 bound, tests/test_elastic.py);
  4. ``launch.train.train_paper``: an interrupted run resumed from its
     checkpoint equals the uninterrupted run exactly, on one device and
     on a world-size-1 group.

Masked epochs keep clients 0, 1 and 3 of 4: the single-device JAX oracle
is ill-conditioned for a mask that keeps 0, 2 and 3 (ROADMAP section 3).
"""
import os

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as JCK
from repro.core import engine as JE
from repro.core import faults as JF
from repro.core import retry as JRT
from repro.optim import sgd_momentum as j_sgd
from repro_torch import checkpoint as CK
from repro_torch.convert import from_jax_numpy
from repro_torch.core import round as TRD
from repro_torch.core.faults import FaultPlan, ensure_group_survivor
from repro_torch.core.retry import RetryError, backoff_schedule, retry_call
from repro_torch.tree import tree_leaves
from test_torch_engine import (BATCH, KEYS, LR, ReplayTake, _assert_state,
                               _port, _replayed_perms, _tdata, _world)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers at once, and with more threads than cores each small op waits
    on the others' threads (measured: 5 s alone, up to 284 s under the
    suite's load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# 1. retry / backoff


def test_backoff_schedule_deterministic_and_bounded():
    a = backoff_schedule(6, base_delay=0.5, max_delay=4.0, seed=3)
    b = backoff_schedule(6, base_delay=0.5, max_delay=4.0, seed=3)
    assert a == b and len(a) == 5  # N attempts -> N-1 sleeps
    assert all(d <= 4.0 * 1.5 for d in a)
    assert backoff_schedule(6, base_delay=0.5, max_delay=4.0, seed=4) != a
    assert backoff_schedule(5, base_delay=1.0, max_delay=4.0,
                            jitter=0.0) == [1.0, 2.0, 4.0, 4.0]
    assert backoff_schedule(1) == []


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("kw", [{}, dict(base_delay=0.25, max_delay=2.0),
                                dict(jitter=0.0), dict(jitter=1.5,
                                                       max_delay=100.0)])
def test_backoff_schedule_equals_jax(seed, kw):
    for attempts in (1, 2, 5, 9):
        assert backoff_schedule(attempts, seed=seed, **kw) == \
            JRT.backoff_schedule(attempts, seed=seed, **kw)


def test_retry_call_succeeds_after_transient_failures():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError(f"transient {len(calls)}")
        return "joined"

    out = retry_call(flaky, attempts=5, base_delay=0.5, max_delay=8.0,
                     seed=1, sleep=slept.append)
    assert out == "joined" and len(calls) == 3
    assert slept == backoff_schedule(5, base_delay=0.5, max_delay=8.0,
                                     seed=1)[:2]


def test_retry_call_exhausts_budget():
    slept = []

    def dead():
        raise ConnectionError("coordinator unreachable")

    with pytest.raises(RetryError, match=r"3 attempt\(s\)") as ei:
        retry_call(dead, attempts=3, sleep=slept.append,
                   describe="join test")
    assert ei.value.attempts == 3
    assert isinstance(ei.value.last, ConnectionError)
    assert ei.value.__cause__ is ei.value.last
    assert "join test" in str(ei.value)
    assert len(slept) == 2
    with pytest.raises(ValueError, match="attempts"):
        retry_call(dead, attempts=0)


def test_retry_call_does_not_catch_unlisted_errors():
    def typed():
        raise ValueError("not transient")

    with pytest.raises(ValueError, match="not transient"):
        retry_call(typed, attempts=5, retry_on=(RuntimeError,),
                   sleep=lambda _: None)


# --------------------------------------------------------------------------
# 2. FaultPlan


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("rates", [(0.2, 0.1), (0.5, 0.5), (0.0, 1.0)])
def test_fault_plan_equals_jax(seed, rates):
    drop, strag = rates
    ours = FaultPlan(10, seed=seed, drop_rate=drop, straggler_rate=strag,
                     straggler_delay=0.05)
    theirs = JF.FaultPlan(10, seed=seed, drop_rate=drop,
                          straggler_rate=strag, straggler_delay=0.05)
    for ep in range(6):
        np.testing.assert_array_equal(ours.available(ep),
                                      theirs.available(ep))
        np.testing.assert_array_equal(ours.delays(ep), theirs.delays(ep))
        for timeout in (None, 0.02, 0.1):
            m, w = ours.participation(ep, straggler_timeout=timeout)
            jm, jw = theirs.participation(ep, straggler_timeout=timeout)
            np.testing.assert_array_equal(m, jm)
            assert w == jw
            for alpha in (1.0, 0.5, 0.2):
                got = ensure_group_survivor(m, 10, alpha=alpha)
                want = JF.ensure_group_survivor(jm, 10, alpha=alpha)
                np.testing.assert_array_equal(got[0], want[0])
                assert got[1] == want[1]


def test_fault_plan_is_pure_function_of_seed_and_epoch():
    a = FaultPlan(8, seed=5, drop_rate=0.4, straggler_rate=0.3)
    b = FaultPlan(8, seed=5, drop_rate=0.4, straggler_rate=0.3)
    for ep in range(4):
        np.testing.assert_array_equal(a.available(ep), b.available(ep))
        np.testing.assert_array_equal(a.delays(ep), b.delays(ep))
    c = FaultPlan(8, seed=6, drop_rate=0.4, straggler_rate=0.3)
    assert any(not np.array_equal(a.available(ep), c.available(ep))
               for ep in range(8))
    assert any(not np.array_equal(a.available(0), a.available(ep))
               for ep in range(1, 8))


def test_fault_plan_straggler_policies():
    plan = FaultPlan(8, seed=0, straggler_rate=1.0, straggler_delay=0.25)
    mask, wait = plan.participation(0, straggler_timeout=None)
    assert mask.all() and wait == 0.25
    mask, wait = plan.participation(0, straggler_timeout=0.1)
    assert not mask.any() and wait == 0.0
    mask, wait = plan.participation(0, straggler_timeout=0.5)
    assert mask.all() and wait == 0.25
    mask, wait = FaultPlan(8).participation(0)
    assert mask.all() and wait == 0.0


def test_fault_plan_kill_schedule():
    plan = FaultPlan(8, kill_process=1, kill_epoch=2)
    assert plan.should_kill(1, 2)
    assert not plan.should_kill(0, 2)
    assert not plan.should_kill(1, 1)
    assert not FaultPlan(8).should_kill(0, 0)
    # maybe_kill is a no-op off-schedule (it would SIGKILL us otherwise)
    plan.maybe_kill(0, 2)
    plan.maybe_kill(1, 0)


def test_ensure_group_survivor():
    # alpha=0.5 over 8 clients -> flush groups [0..3], [4..7]
    mask, revived = ensure_group_survivor(
        np.array([0, 0, 0, 0, 1, 0, 1, 0], bool), 8, alpha=0.5)
    assert revived == [0]
    np.testing.assert_array_equal(
        mask, np.array([1, 0, 0, 0, 1, 0, 1, 0], bool))
    ok = np.array([0, 1, 0, 0, 0, 0, 0, 1], bool)
    mask, revived = ensure_group_survivor(ok, 8, alpha=0.5)
    assert revived == [] and np.array_equal(mask, ok)
    mask, revived = ensure_group_survivor(np.zeros(8, bool), 8, alpha=0.5)
    assert revived == [0, 4] and mask.sum() == 2
    with pytest.raises(ValueError, match="shape"):
        ensure_group_survivor(np.ones(4, bool), 8)


# --------------------------------------------------------------------------
# 3. checkpoints


def test_checkpoint_atomic_no_tmp_litter(tmp_path):
    path = str(tmp_path / "ck.npz")
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1.5, -2.25, 3.0], dtype=torch.bfloat16),
                  "n": torch.tensor(7, dtype=torch.int32)}}
    CK.save_checkpoint(path, tree, step=3)
    assert os.listdir(tmp_path) == ["ck.npz"]   # no temp file left
    with np.load(path) as data:
        assert sorted(data.files) == ["__step__", "a", "b/c", "b/n"]
        assert data["b/c"].dtype == np.float32  # bf16 widened
    out, step = CK.restore_checkpoint(path, tree)
    assert step == 3
    assert torch.equal(out["a"], tree["a"])
    assert out["b"]["c"].dtype == torch.bfloat16   # re-cast to the ref's
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["n"].dtype == torch.int32 and int(out["b"]["n"]) == 7
    # a second save replaces the first whole
    CK.save_checkpoint(path, {"a": tree["a"] + 1, "b": tree["b"]})
    out, step = CK.restore_checkpoint(path, tree)
    assert step is None and torch.equal(out["a"], tree["a"] + 1)
    assert os.listdir(tmp_path) == ["ck.npz"]


def test_checkpoint_raises_on_mismatch(tmp_path):
    path = str(tmp_path / "ck.npz")
    CK.save_checkpoint(path, {"a": torch.ones(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        CK.restore_checkpoint(path, {"a": torch.ones(3, 2)})
    with pytest.raises(ValueError, match="no leaf"):
        CK.restore_checkpoint(path, {"a": torch.ones(2, 3),
                                     "zz": torch.ones(())})


def _port_state(n=4):
    from repro_torch.core import engine as E
    from repro_torch.models import resnet as R
    from repro_torch.optim import sgd_momentum
    cfg = R.ResNetConfig(depth=8, num_classes=n, width=8)
    opt = sgd_momentum(0.05, momentum=0.9, weight_decay=5e-4)
    return E.init_dcml_state(torch.Generator().manual_seed(0),
                             lambda g: R.init(g, cfg), n, opt, opt)


def test_train_state_roundtrip(tmp_path):
    st = _port_state()
    gen = torch.Generator().manual_seed(1)
    torch.rand(7, generator=gen)            # a state mid-stream
    path = str(tmp_path / "state.npz")
    CK.save_train_state(path, st, gen=gen, epoch=2)
    st2, gen_state, epoch = CK.restore_train_state(path, _zeros_like(st))
    assert epoch == 2
    for a, b in zip(tree_leaves(st), tree_leaves(st2)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    resumed = torch.Generator()
    resumed.set_state(gen_state)
    assert torch.equal(torch.rand(5, generator=resumed),
                       torch.rand(5, generator=gen))
    # a plain param checkpoint is not a train-state snapshot
    CK.save_checkpoint(str(tmp_path / "p.npz"), {"a": torch.ones(())})
    with pytest.raises(ValueError, match="no leaf"):
        CK.restore_train_state(str(tmp_path / "p.npz"),
                               {"a": torch.ones(())})
    # write=False fetches but writes nothing
    CK.save_train_state(str(tmp_path / "none.npz"), st, gen=gen, epoch=1,
                        write=False)
    assert not os.path.exists(tmp_path / "none.npz")


def _zeros_like(tree):
    from repro_torch.tree import tree_map
    return tree_map(torch.zeros_like, tree)


def _unflatten(flat):
    """'/'-joined keys -> nested dicts."""
    out = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def test_jax_train_state_resumes_in_the_port(tmp_path):
    """JAX's ``save_train_state`` after one epoch, read with ``np.load``
    and carried over with ``from_jax_numpy``: params, momentum, BN
    statistics and step bitwise; one masked epoch more (JAX's permutations
    replayed) matches JAX's at <= 1e-5. The first epoch is unmasked: after
    a masked one, the next masked epoch of this world is bimodal under the
    collector's permutation in both packages (ROADMAP section 3)."""
    n, steps, alpha = 4, 2, 0.5
    cfg, data, st0, _ = _world()
    split_j = JE.make_resnet_split(cfg)
    opt_j = j_sgd(LR, momentum=0.9, weight_decay=5e-4)
    mask = np.array([True, True, False, True])
    epoch_j = jax.jit(lambda k, s, m: JE.sfpl_epoch(
        k, s, data, split_j, opt_j, opt_j, num_clients=n, batch_size=BATCH,
        alpha=alpha, participation=m))
    st1, _ = epoch_j(jax.random.PRNGKey(3), st0, np.ones(n, bool))
    path = str(tmp_path / "jax_state.npz")
    JCK.save_train_state(path, st1, key=jax.random.PRNGKey(5), epoch=1)

    with np.load(path) as f:
        flat = {k: f[k] for k in f.files}
    assert int(flat.pop("__step__")) == 1
    tree = _unflatten(flat)
    st_t = from_jax_numpy(tree["st"])
    want = from_jax_numpy(jax.tree_util.tree_map(np.asarray, st1))
    for k in KEYS:
        for a, b in zip(tree_leaves(st_t[k]), tree_leaves(want[k])):
            assert a.dtype == b.dtype and torch.equal(a, b), k
    assert st_t["copt"]["mu"]["conv1"]["w"].abs().max() > 0   # momentum

    ke = jax.random.PRNGKey(7)
    st_j, losses_j = epoch_j(ke, st1, mask)
    split_t, opt_t = _port(n)
    perms = _replayed_perms(ke, steps, n * BATCH, n, alpha)
    st_t, losses_t = TRD.sfpl_round(
        None, st_t, _tdata(data), split_t, opt_t, opt_t, num_clients=n,
        batch_size=BATCH,
        collector=ReplayTake(n, alpha=alpha, perms=iter(perms)),
        participation=torch.from_numpy(mask), device="cpu")
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                               rtol=1e-5, atol=1e-5)
    _assert_state(st_t, st_j, KEYS)


# --------------------------------------------------------------------------
# 4. the launcher: save, resume


FAULTS = dict(drop_rate=0.3, straggler_rate=0.3, straggler_delay=0.01,
              straggler_timeout=0.005, fault_seed=2)


@pytest.mark.parametrize("sharded", [False, True])
def test_train_paper_resume_equals_uninterrupted(tmp_path, capsys, sharded):
    from repro_torch.launch.train import train_paper
    kw = dict(num_clients=4, batch_size=2, device="cpu", alpha=0.5,
              sharded=sharded, **FAULTS)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    full = train_paper(epochs=3, ckpt=a, ckpt_every=1, **kw)
    first = train_paper(epochs=2, ckpt=b, ckpt_every=1, **kw)
    assert first == full[:2]
    rest = train_paper(epochs=3, resume=b, ckpt=b, **kw)
    assert rest == full[2:]          # bitwise: same floats
    out = capsys.readouterr().out
    assert "resumed from" in out and "at epoch 2" in out
    assert out.count("participation") == 3 + 2 + 1
    for name in (a, b):
        st, _, epoch = CK.restore_train_state(name, _port_state())
        assert epoch == 3
    sa, _, _ = CK.restore_train_state(a, _port_state())
    sb, _, _ = CK.restore_train_state(b, _port_state())
    for x, y in zip(tree_leaves(sa), tree_leaves(sb)):
        assert torch.equal(x, y)
    assert not torch.distributed.is_initialized()


def test_train_paper_masks_are_the_plans(capsys):
    """The launcher's per-epoch participation is the plan's draw after
    ``ensure_group_survivor``, revivals logged."""
    from repro_torch.launch.train import train_paper
    train_paper(num_clients=4, batch_size=2, epochs=4, device="cpu",
                alpha=0.5, drop_rate=0.6, fault_seed=1)
    out = capsys.readouterr().out
    plan = FaultPlan(4, seed=1, drop_rate=0.6)
    n_revived = 0
    for ep in range(4):
        mask, wait = plan.participation(ep)
        mask, revived = ensure_group_survivor(mask, 4, alpha=0.5)
        n_revived += len(revived)
        assert (f"epoch {ep:3d} participation {int(mask.sum())}/4 "
                f"(straggler wait {wait:.2f}s)") in out
        if revived:
            assert f"epoch {ep:3d} revived clients {revived}" in out
    assert n_revived > 0


def test_rates_need_sfpl():
    """A straggler rate alone is a fault rate too: on SFLv2 it raises, from
    the CLI and from ``train_paper``, as in the JAX launcher."""
    from repro_torch.launch.train import main, train_paper
    with pytest.raises(ValueError, match="requires --scheme sfpl"):
        main(["--paper", "--scheme", "sflv2", "--straggler-rate", "0.1",
              "--device", "cpu", "--epochs", "1"])
    with pytest.raises(ValueError, match="requires --scheme sfpl"):
        train_paper(scheme="sflv2", straggler_rate=0.1, num_clients=4,
                    epochs=1, device="cpu")
