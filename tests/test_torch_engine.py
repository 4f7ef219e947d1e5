"""The port's epochs against the JAX package's on the same state and data.

State comes from the JAX ``init_dcml_state`` / ``init_fl_state`` and data
from the JAX generator, carried over through ``repro_torch.convert``. The
per-step collector permutations are drawn in JAX by replaying
``sfpl_round``'s key splits and handed to the port through a test-local
``DenseTake`` whose ``make_perm`` returns them; SFLv2's visitation order
is handed over the same way. Compared: the loss trajectory and the final
``cp``/``cbn``/``sp``/``sbn``/``copt``/``sopt`` (f32: <= 1e-5), BN
``count`` leaves included, and one bf16 epoch with the JAX Pallas kernels
in interpret mode against the port's plain versions (loss <= 1e-2).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collector as JC
from repro.core import engine as JE
from repro.core import round as JRD
from repro.data import make_synthetic_cifar, partition_positive_labels
from repro.models import resnet as JR
from repro.models.common import ComputePolicy as JPolicy
from repro.optim import sgd_momentum as j_sgd
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.core import engine as TE
from repro_torch.core import round as TRD
from repro_torch.models import resnet as TR
from repro_torch.models.common import ComputePolicy as TPolicy
from repro_torch.optim import sgd_momentum as t_sgd

BATCH, HW, LR = 2, 8, 0.05
KEYS = ("cp", "cbn", "sp", "sbn", "copt", "sopt", "step")


@dataclasses.dataclass(frozen=True)
class ReplayTake(TRD.DenseTake):
    """DenseTake whose permutations are the JAX engine's, in order."""
    perms: object = None

    def make_perm(self, gen, n, device=None):
        return torch.from_numpy(np.array(next(self.perms))).to(device)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.cache
def _world():
    """JAX config, data and initial states (numpy): 4 clients, one class
    each, 2 local steps of batch 2."""
    n, steps = 4, 2
    cfg = JR.ResNetConfig(depth=8, num_classes=n, width=8)
    tx, ty, _, _ = jax.jit(functools.partial(
        make_synthetic_cifar, num_classes=n, train_per_class=steps * BATCH,
        test_per_class=2, hw=HW))(jax.random.PRNGKey(0))
    data = _host(partition_positive_labels(tx, ty, n))
    opt = j_sgd(LR, momentum=0.9, weight_decay=5e-4)
    params = _host(jax.jit(lambda k: JR.init(k, cfg))(jax.random.PRNGKey(0)))
    st = _host(JE.init_dcml_state(None, lambda k: params, n, opt, opt))
    fl = _host(JE.init_fl_state(None, lambda k: params, n, opt))
    return cfg, data, st, fl


def _port(n_clients, policy=None):
    cfg = TR.ResNetConfig(depth=8, num_classes=n_clients, width=8)
    return (TE.make_resnet_split(cfg, policy=policy),
            t_sgd(LR, momentum=0.9, weight_decay=5e-4))


def _tdata(data):
    return {"x": torch.from_numpy(np.array(data["x"])),
            "y": torch.from_numpy(np.array(data["y"])).long()}


def _replayed_perms(key, steps, n_pool, n_clients, alpha):
    """The permutations sfpl_round draws: one key split per step."""
    perms = []
    for _ in range(steps):
        key, kperm = jax.random.split(key)
        perms.append(np.asarray(JC.make_flush_perm(kperm, n_pool, n_clients,
                                                   alpha)))
    return perms


def _assert_state(st_t, st_j, keys, tol=1e-5):
    for k in keys:
        a = jax.tree_util.tree_leaves(to_numpy({k: st_t[k]}))
        b = jax.tree_util.tree_leaves(_host({k: st_j[k]}))
        assert len(a) == len(b), k
        for u, v in zip(a, b):
            np.testing.assert_allclose(u, v, rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("alpha", [0.5, 1.0])
@pytest.mark.parametrize("masked", [False, True])
def test_sfpl_epoch_matches_jax(alpha, masked):
    n, steps = 4, 2
    cfg, data, st0, _ = _world()
    split_j = JE.make_resnet_split(cfg)
    opt_j = j_sgd(LR, momentum=0.9, weight_decay=5e-4)
    mask = np.array([True, False, True, True]) if masked else None
    ke = jax.random.PRNGKey(7)
    st_j, losses_j = jax.jit(lambda k, s, d, m: JE.sfpl_epoch(
        k, s, d, split_j, opt_j, opt_j, num_clients=n, batch_size=BATCH,
        alpha=alpha, participation=m))(ke, st0, data, mask)

    split_t, opt_t = _port(n)
    perms = _replayed_perms(ke, steps, n * BATCH, n, alpha)
    st_t, losses_t = TRD.sfpl_round(
        None, from_jax_numpy(st0), _tdata(data), split_t, opt_t, opt_t,
        num_clients=n, batch_size=BATCH,
        collector=ReplayTake(n, alpha=alpha, perms=iter(perms)),
        participation=None if mask is None else torch.from_numpy(mask),
        device="cpu")
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                               rtol=1e-5, atol=1e-5)
    _assert_state(st_t, st_j, KEYS)
    if not masked:
        # the client forward moves client BN stats twice per step (first
        # forward + the recomputed forward in the local update); the
        # server's once
        assert float(st_t["cbn"]["bn1"]["count"][0]) == 2 * steps
        assert float(st_t["sbn"]["s0b0"]["bn1"]["count"]) == steps


def test_sfpl_epoch_entry_point_runs_on_cpu():
    """The public entry point with its own permutations: same shapes and
    BN counts as the JAX epoch, finite losses."""
    n, steps = 4, 2
    _, data, st0, _ = _world()
    split_t, opt_t = _port(n)
    st_t, losses = TE.sfpl_epoch(
        torch.Generator().manual_seed(0), from_jax_numpy(st0), _tdata(data),
        split_t, opt_t, opt_t, num_clients=n, batch_size=BATCH,
        device="cpu")
    assert losses.shape == (steps,) and torch.isfinite(losses).all()
    assert int(st_t["step"]) == steps


def test_sflv2_epoch_matches_jax(monkeypatch):
    """Two server updates (2 clients x 1 step): SFLv2's sequential
    single-class stream amplifies float-order noise with every update, so
    longer chains drift past 1e-5 (.claude/skills/verify/SKILL.md)."""
    n = 2
    cfg, data, st0, _ = _world()
    clients = lambda a: a[:n]
    st0 = dict(st0, **{k: jax.tree_util.tree_map(clients, st0[k])
                       for k in ("cp", "cbn", "copt")})
    data = {"x": data["x"][:n, :BATCH], "y": data["y"][:n, :BATCH]}
    split_j = JE.make_resnet_split(cfg)
    opt_j = j_sgd(LR, momentum=0.9, weight_decay=5e-4)
    ke = jax.random.PRNGKey(3)
    st_j, losses_j = jax.jit(lambda k, s, d: JE.sflv2_epoch(
        k, s, d, split_j, opt_j, opt_j, num_clients=n,
        batch_size=BATCH))(ke, st0, data)
    order = np.asarray(jax.random.permutation(ke, n)).tolist()
    monkeypatch.setattr(TRD, "visit_order", lambda gen, num: order)

    split_t, opt_t = _port(n)
    st_t, losses_t = TE.sflv2_epoch(
        None, from_jax_numpy(st0), _tdata(data), split_t, opt_t, opt_t,
        num_clients=n, batch_size=BATCH, device="cpu")
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                               rtol=1e-5, atol=1e-5)
    _assert_state(st_t, st_j, KEYS)


def test_fl_epoch_matches_jax():
    n, steps = 4, 2
    cfg, data, _, fl0 = _world()
    split_j = JE.make_resnet_split(cfg)
    opt_j = j_sgd(LR, momentum=0.9, weight_decay=5e-4)
    st_j, losses_j = jax.jit(lambda k, s, d: JE.fl_epoch(
        k, s, d, split_j, opt_j, num_clients=n, batch_size=BATCH))(
        jax.random.PRNGKey(0), fl0, data)
    split_t, opt_t = _port(n)
    st_t, losses_t = TE.fl_epoch(
        None, from_jax_numpy(fl0), _tdata(data), split_t, opt_t,
        num_clients=n, batch_size=BATCH, device="cpu")
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j),
                               rtol=1e-5, atol=1e-5)
    _assert_state(st_t, st_j, ("p", "bn", "opt", "step"))


def test_bf16_sfpl_epoch_kernels_vs_port_plain():
    """JAX with every Pallas kernel of the path in interpret mode (the
    collector shuffle, bn_act, softmax_xent) against the port's plain
    versions of the same kernels: loss <= 1e-2."""
    n, steps, alpha = 4, 2, 0.5
    cfg, data, st0, _ = _world()
    split_j = JE.make_resnet_split(cfg, policy=JPolicy(
        "bfloat16", use_fused_kernels=True, kernel_interpret=True))
    opt_j = j_sgd(LR, momentum=0.9, weight_decay=5e-4)
    ke = jax.random.PRNGKey(5)
    _, losses_j = jax.jit(lambda k, s, d: JRD.sfpl_round(
        k, s, d, split_j, opt_j, opt_j, num_clients=n, batch_size=BATCH,
        collector=JRD.DenseTake(n, alpha=alpha, use_kernel=True)))(
        ke, st0, data)

    split_t, opt_t = _port(n, TPolicy("bfloat16", use_fused_kernels=True))
    perms = _replayed_perms(ke, steps, n * BATCH, n, alpha)
    st_t, losses_t = TRD.sfpl_round(
        None, from_jax_numpy(st0), _tdata(data), split_t, opt_t, opt_t,
        num_clients=n, batch_size=BATCH,
        collector=ReplayTake(n, alpha=alpha, use_kernel=True,
                             perms=iter(perms)), device="cpu")
    assert np.abs(losses_t.numpy() - np.asarray(losses_j)).max() <= 1e-2
    assert all(t.dtype == torch.float32
               for t in jax.tree_util.tree_leaves(st_t["sp"]))


def test_evaluation_matches_jax():
    """IID and non-IID evaluation (RMSD and CMSD), FL evaluation and the
    weight divergence on the same trained-for-one-epoch state."""
    from repro.core import evaluate as JEV
    from repro_torch.core import evaluate as TEV
    n = 4
    cfg, data, st0, fl0 = _world()
    split_j = JE.make_resnet_split(cfg)
    opt_j = j_sgd(LR, momentum=0.9, weight_decay=5e-4)
    st_j, _ = jax.jit(lambda k, s, d: JE.sfpl_epoch(
        k, s, d, split_j, opt_j, opt_j, num_clients=n, batch_size=BATCH))(
        jax.random.PRNGKey(1), st0, data)
    st_j = _host(st_j)
    split_t, _ = _port(n)
    st_t = from_jax_numpy(st_j)
    x = data["x"].reshape((-1,) + data["x"].shape[2:])
    y = data["y"].reshape(-1)
    xt, yt = torch.from_numpy(np.array(x)), torch.from_numpy(np.array(y))
    for rmsd in (True, False):
        for fn_j, fn_t, kw in (
                (JEV.evaluate_split_noniid, TEV.evaluate_split_noniid,
                 {"batch": 2}),
                (JEV.evaluate_split_iid, TEV.evaluate_split_iid,
                 {"batch": 4})):
            rj = fn_j(st_j, split_j, x, y, n, rmsd=rmsd, **kw)
            rt = fn_t(st_t, split_t, xt, yt, n, rmsd=rmsd, **kw)
            for key in ("accuracy", "precision@1", "recall", "f1"):
                assert abs(rt[key] - rj[key]) <= 1e-5, (fn_t, rmsd, key)
    rj = JEV.evaluate_fl(_host(fl0), split_j, x, y, n, batch=4)
    rt = TEV.evaluate_fl(from_jax_numpy(fl0), split_t, xt, yt, n, batch=4)
    assert abs(rt["accuracy"] - rj["accuracy"]) <= 1e-5
    wj = JEV.weight_divergence(st_j["sp"], st0["sp"])
    wt = TEV.weight_divergence(st_t["sp"], from_jax_numpy(st0)["sp"])
    np.testing.assert_allclose(float(wt), float(wj), rtol=1e-5)
