"""The paper's comparison (``launch/eval.py --paper``) and the small public
pieces of the main path, against the JAX package.

Inputs are made from a seed with numpy, or by the JAX package and carried
over through numpy. ``evaluate_paper`` runs at a tiny config (ResNet-8
width 8, 8x8 images, 4 clients, 2 epochs, f32) on JAX's data and initial
state, with JAX's per-step permutations and SFLv2 visit orders handed in
through the test-local ``DenseTake`` substitution of
``tests/test_torch_engine.py``; every accuracy equals JAX's within one
test sample. The behavioural tests of ``tests/test_core.py`` run on JAX's
``tiny_setup`` carried over, at JAX's thresholds, with the port's own
permutations from the reference's seeds.
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
from repro.data import augment as JA
from repro.data import make_synthetic_cifar as j_cifar
from repro.data import partition_positive_labels as j_partition
from repro.launch import eval as JEV
from repro.metrics import classification as JM
from repro.models import common as JMC
from repro.models import resnet as JR
from repro.nn import init as JI
from repro.optim import sgd_momentum as j_sgd
from repro_torch.convert import from_jax_numpy
from repro_torch.core import collector as TC
from repro_torch.core import engine as TE
from repro_torch.core import round as TRD
from repro_torch.core.evaluate import (evaluate_split_iid,
                                       evaluate_split_noniid)
from repro_torch.data import augment as TA
from repro_torch.data import synthetic as TS
from repro_torch.launch import eval as TEV
from repro_torch.metrics import classification as TM
from repro_torch.models import common as TMC
from repro_torch.models import resnet as TR
from repro_torch.nn import init as TI
from repro_torch.optim import sgd_momentum as t_sgd


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# --------------------------------------------------------------------------
# the small pieces

def test_inverse_permutation_matches_jax():
    perm = np.random.default_rng(0).permutation(37)
    np.testing.assert_array_equal(
        TC.inverse_permutation(_t(perm)).numpy(),
        np.asarray(JC.inverse_permutation(jnp.asarray(perm))))


@pytest.mark.parametrize("alpha", [1.0, 0.5])
def test_global_collector_matches_jax(alpha):
    """shuffle_pool and deshuffle_grads under JAX's pool permutation
    (the port's draw replaced by it): equal rows, labels, grads."""
    n_clients, batch = 4, 3
    rng = np.random.default_rng(1)
    acts = rng.standard_normal((n_clients, batch, 2, 2, 5)).astype(
        np.float32)
    labels = rng.integers(0, 10, (n_clients, batch))
    grads = rng.standard_normal((n_clients * batch, 2, 2, 5)).astype(
        np.float32)
    jcoll = JC.GlobalCollector(n_clients, alpha=alpha)
    ja, jy, jperm = jcoll.shuffle_pool(jax.random.PRNGKey(2),
                                       jnp.asarray(acts), jnp.asarray(labels))

    class Given(TC.GlobalCollector):
        def make_pool_perm(self, gen, n, device=None):
            return _t(jperm).long()
    tcoll = Given(n_clients, alpha=alpha)
    ta, ty, tperm = tcoll.shuffle_pool(None, _t(acts), _t(labels))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(
        tcoll.deshuffle_grads(_t(grads), tperm).numpy(),
        np.asarray(jcoll.deshuffle_grads(jnp.asarray(grads), jperm)))
    # the port's own draw keeps every row inside its flush group
    perm = TC.GlobalCollector(n_clients, alpha=alpha).make_pool_perm(
        torch.Generator().manual_seed(0), n_clients * batch)
    for c0, c1 in ((0, 2), (2, 4)) if alpha == 0.5 else ((0, 4),):
        part = perm[c0 * batch:c1 * batch].sort().values
        assert part.tolist() == list(range(c0 * batch, c1 * batch))


def test_sgd_nesterov_state_dtype_matches_jax():
    """Three steps of Nesterov SGD with a bf16 momentum: f32 params within
    1e-6, the bf16 state within one bf16 ulp."""
    rng = np.random.default_rng(3)
    p0 = {"w": rng.standard_normal((6, 5)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    gs = [{k: rng.standard_normal(v.shape).astype(np.float32)
           for k, v in p0.items()} for _ in range(3)]
    kw = dict(momentum=0.9, weight_decay=5e-4, nesterov=True)
    jopt = j_sgd(0.1, state_dtype=jnp.bfloat16, **kw)
    topt = t_sgd(0.1, state_dtype=torch.bfloat16, **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _t(v) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    assert all(v.dtype == torch.bfloat16 for v in ts["mu"].values())
    for step, g in enumerate(gs):
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                             jp, step)
        tp, ts = topt.update({k: _t(v) for k, v in g.items()}, ts, tp, step)
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6)
            mu_j = np.asarray(js["mu"][k].astype(jnp.float32))
            mu_t = ts["mu"][k].float().numpy()
            ulp = np.abs(mu_j) * 2.0 ** -7
            assert (np.abs(mu_t - mu_j) <= np.maximum(ulp, 1e-30)).all()


def test_uniform_scaling_statistics_match_jax():
    """U(-lim, lim), lim = scale * sqrt(3 / fan_in): both draws lie in
    the bounds, reach near them, and have the same mean and std."""
    shape, scale = (64, 512), 0.7
    lim = scale * np.sqrt(3.0 / 64)
    j = np.asarray(JI.uniform_scaling(jax.random.PRNGKey(4), shape, scale))
    t = TI.uniform_scaling(torch.Generator().manual_seed(4), shape,
                           scale).numpy()
    for x in (j, t):
        assert x.shape == shape and x.dtype == np.float32
        assert np.abs(x).max() <= lim and np.abs(x).max() > 0.99 * lim
        assert abs(x.mean()) < 0.01 * lim
        assert abs(x.std() - lim / np.sqrt(3)) < 0.01 * lim
    assert abs(j.std() - t.std()) < 0.01 * lim


def test_count_params_and_client_flops_match_jax():
    for depth, width, classes in ((8, 8, 4), (56, 16, 100)):
        jcfg = JR.ResNetConfig(depth=depth, num_classes=classes,
                               width=width)
        tcfg = TR.ResNetConfig(depth=depth, num_classes=classes,
                               width=width)
        jp, _ = jax.eval_shape(lambda k: JR.init(k, jcfg),
                               jax.random.PRNGKey(0))
        tp, _ = TR.init(torch.Generator().manual_seed(0), tcfg)
        assert TMC.count_params(tp) == JMC.count_params(jp)
        assert TMC.count_params(tp["client"]) == \
            JMC.count_params(jp["client"])
        for hw in (8, 32):
            assert TR.client_flops_per_datapoint(tcfg, hw) == \
                JR.client_flops_per_datapoint(jcfg, hw)


@pytest.mark.parametrize("pad", [1, 4])
def test_augment_matches_jax_given_draws(pad):
    """JAX's ``augment_batch`` against the port's flip and crop fed JAX's
    own flips and offsets (its two key draws replayed): equal, exactly;
    ``normalize`` equal too."""
    x = np.random.default_rng(5).standard_normal((6, 8, 8, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(6)
    want = np.asarray(JA.augment_batch(key, jnp.asarray(x), pad=pad))
    kf, kc = jax.random.split(key)
    flip = np.asarray(jax.random.bernoulli(kf, 0.5, (6,)))
    offs = np.asarray(jax.random.randint(kc, (6, 2), 0, 2 * pad + 1))
    assert flip.any() and not flip.all()
    got = TA.flip_crop(_t(x), _t(flip), _t(offs), pad=pad).numpy()
    np.testing.assert_array_equal(got, want)
    own = TA.augment_batch(torch.Generator().manual_seed(0), _t(x), pad=pad)
    assert tuple(own.shape) == x.shape
    mean, std = [0.49, 0.48, 0.45], [0.25, 0.24, 0.26]
    np.testing.assert_array_equal(
        TA.normalize(_t(x), mean, std).numpy(),
        np.asarray(JA.normalize(jnp.asarray(x), mean, std)))


def test_classification_metrics_match_jax():
    rng = np.random.default_rng(7)
    classes = 6
    labels = rng.integers(0, classes, 200)
    preds = np.where(rng.random(200) < 0.6, labels,
                     rng.integers(0, classes, 200))
    preds[preds == 5] = 4                 # a class never predicted
    for tf, jf in ((TM.precision_at_1, JM.precision_at_1),
                   (TM.recall_macro, JM.recall_macro),
                   (TM.f1_macro, JM.f1_macro)):
        got = float(tf(_t(preds), _t(labels), classes))
        want = float(jf(jnp.asarray(preds), jnp.asarray(labels), classes))
        assert got == want, tf.__name__


# --------------------------------------------------------------------------
# evaluate_paper against JAX's

PAPER = dict(num_clients=4, epochs=2, depth=8, width=8, hw=8)


@functools.cache
def _jax_paper():
    """JAX's evaluate_paper at the tiny config, and what it drew: data,
    initial params, the SFPL step permutations and the SFLv2 orders."""
    n, batch, seed = PAPER["num_clients"], 8, 0
    rep = JEV.evaluate_paper(**PAPER)
    data = j_cifar(jax.random.PRNGKey(seed), num_classes=n,
                   train_per_class=4 * batch, test_per_class=2 * batch,
                   hw=PAPER["hw"])
    cfg = JR.ResNetConfig(depth=PAPER["depth"], num_classes=n,
                          width=PAPER["width"])
    init = JR.init(jax.random.PRNGKey(seed), cfg)
    perms, orders = [], []
    k = jax.random.PRNGKey(seed + 1)
    for _ in range(PAPER["epochs"]):
        k, ke = jax.random.split(k)
        orders.append(np.asarray(jax.random.permutation(ke, n)).tolist())
        key = ke
        for _ in range(4):                 # 4 local batches an epoch
            key, kperm = jax.random.split(key)
            perms.append(np.asarray(JC.make_flush_perm(kperm, n * batch, n,
                                                       1.0)))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return rep, host(data), host(init), perms, orders


@dataclasses.dataclass(frozen=True)
class ReplayTake(TRD.DenseTake):
    """DenseTake whose permutations are the JAX engine's, in order."""
    perms: object = None

    def make_perm(self, gen, n, device=None):
        return _t(next(self.perms)).long().to(device)


def test_evaluate_paper_matches_jax(monkeypatch):
    rep_j, data, (params, state), perms, orders = _jax_paper()
    tx, ty, ex, ey = data
    monkeypatch.setattr(TS, "make_synthetic_cifar", lambda *a, **k: (
        _t(tx), _t(ty).long(), _t(ex), _t(ey).long()))
    monkeypatch.setattr(TR, "init", lambda gen, cfg: (
        from_jax_numpy(params), from_jax_numpy(state)))
    it = iter(perms)
    monkeypatch.setattr(TRD.SingleDevice, "collector", lambda self, n, **kw:
                        ReplayTake(n, alpha=kw.get("alpha", 1.0), perms=it))
    order_it = iter(orders)
    monkeypatch.setattr(TRD, "visit_order", lambda gen, n: next(order_it))
    rep_t = TEV.evaluate_paper(device="cpu", **PAPER)
    assert set(rep_j) <= set(rep_t)
    one = 100.0 / len(ey)                  # one test sample, in percent
    for scheme in ("sfpl", "sflv2"):
        assert set(rep_j[scheme]) <= set(rep_t[scheme])
        for proto in ("iid", "noniid"):
            got = rep_t[scheme][proto]["accuracy"]
            want = rep_j[scheme][proto]["accuracy"]
            assert abs(got - want) <= one + 1e-9, (scheme, proto, got, want)
        assert rep_t[scheme]["seconds"] > 0
    assert next(it, None) is None and next(order_it, None) is None


def test_eval_main_paper_lines_and_lm_raises(capsys):
    TEV.main(["--paper", "--device", "cpu", "--clients", "4", "--epochs",
              "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("matched fleet (4 clients, sharded=False")
    assert out[1].lstrip().startswith("sfpl ") and "IID test" in out[1]
    assert out[2].lstrip().startswith("sflv2") and "non-IID test" in out[2]
    # LM mode is ported, for all ten architectures; an unknown one raises
    with pytest.raises(KeyError, match="unknown arch"):
        TEV.main(["--arch", "no-such-arch", "--device", "cpu"])
    TEV.main(["--device", "cpu", "--batches", "1"])
    out = capsys.readouterr().out
    assert out.startswith("qwen3-8b: loss ") and "token-acc" in out


# --------------------------------------------------------------------------
# the behavioural tests of tests/test_core.py on JAX's tiny_setup

@functools.cache
def _tiny():
    V = 4
    tx, ty, ex, ey = j_cifar(jax.random.PRNGKey(0), num_classes=V,
                             train_per_class=32, test_per_class=16, hw=16)
    data = jax.tree_util.tree_map(np.asarray, j_partition(tx, ty, V))
    jcfg = JR.ResNetConfig(depth=8, num_classes=V, width=8)
    inits = {s: jax.tree_util.tree_map(
        np.asarray, JR.init(jax.random.PRNGKey(s), jcfg)) for s in (0, 2)}
    return V, data, (np.asarray(ex), np.asarray(ey)), inits


def _epoch_keys(seed, epochs, first_unsplit=False):
    """The epoch keys of the reference test's loop: ``key, ke =
    split(key)`` each epoch (the loss test feeds its first epoch the key
    itself)."""
    key, out = jax.random.PRNGKey(seed), []
    for e in range(epochs):
        if first_unsplit and e == 0:
            out.append(key)
            continue
        key, ke = jax.random.split(key)
        out.append(ke)
    return out


def _sfpl_perms(keys, n, steps=4):
    """sfpl_round's permutations for each epoch key, in order."""
    perms = []
    for key in keys:
        for _ in range(steps):
            key, kperm = jax.random.split(key)
            perms.append(np.asarray(JC.make_flush_perm(kperm, n, 4, 1.0)))
    return iter(perms)


def _tiny_port(seed):
    V, data, (ex, ey), inits = _tiny()
    cfg = TR.ResNetConfig(depth=8, num_classes=V, width=8)
    split = TE.make_resnet_split(cfg)
    opt = t_sgd(0.05, momentum=0.9, weight_decay=5e-4)
    params, state = inits[seed]
    st = TE.init_dcml_state(None, lambda g: (from_jax_numpy(params),
                                             from_jax_numpy(state)),
                            V, opt, opt)
    tdata = {"x": _t(data["x"]), "y": _t(data["y"]).long()}
    return V, split, opt, st, tdata, (_t(ex), _t(ey).long())


def test_sfpl_learns_under_positive_labels():
    """The reference's test: JAX's data, init (key 0) and the
    permutations of its epoch keys (key 1)."""
    V, split, opt, st, data, (ex, ey) = _tiny_port(0)
    coll = ReplayTake(V, perms=_sfpl_perms(_epoch_keys(1, 5), V * 8))
    for _ in range(5):
        st, _ = TRD.sfpl_round(None, st, data, split, opt, opt,
                               num_clients=V, batch_size=8, bn_mode="cmsd",
                               collector=coll, device="cpu")
    rep = evaluate_split_noniid(st, split, ex, ey, V, rmsd=False, batch=16)
    assert rep["accuracy"] > 60.0, rep   # chance = 25%


def test_sflv2_fails_under_positive_labels(monkeypatch):
    """The reference's test: JAX's data, init and visit orders (key 1)."""
    V, split, opt, st, data, (ex, ey) = _tiny_port(0)
    orders = iter([np.asarray(jax.random.permutation(k, V)).tolist()
                   for k in _epoch_keys(1, 5)])
    monkeypatch.setattr(TRD, "visit_order", lambda gen, n: next(orders))
    for _ in range(5):
        st, _ = TE.sflv2_epoch(None, st, data, split, opt, opt,
                               num_clients=V, batch_size=8, device="cpu")
    rep = evaluate_split_iid(st, split, ex, ey, V, rmsd=True, batch=16)
    # collapses toward chance (paper Table I: 10% at 10 classes)
    assert rep["accuracy"] < 45.0, rep


def test_sfpl_loss_decreases():
    """The reference's test: init key 2, epoch keys from key 3."""
    V, split, opt, st, data, _ = _tiny_port(2)
    coll = ReplayTake(V, perms=_sfpl_perms(
        _epoch_keys(3, 4, first_unsplit=True), V * 8))
    run = lambda st: TRD.sfpl_round(None, st, data, split, opt, opt,
                                    num_clients=V, batch_size=8,
                                    collector=coll, device="cpu")
    st, first = run(st)
    for _ in range(3):
        st, last = run(st)
    assert float(last.mean()) < float(first.mean())
