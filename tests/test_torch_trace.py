"""The port's spans and counters (``repro_torch.trace``) on a tiny SFPL round.

A ResNet-8 round of 3 clients, batch 4, 2 steps, on the bf16 policy with
the fused kernels on (so the wrappers run their plain versions here), run
under ``torch.profiler`` with CPU rows: every step holds one ``sfpl.step``
with the phases nested in it, each BatchNorm call its ``bn.stats`` and
``bn.act``, and the round its ``sfpl.fedavg``; the state and losses are
bit for bit those of the round without a profiler, under which no span
reaches the recorder; ``COUNTERS["sfpl"]`` counts the run; the kernels'
``LAUNCHES`` and ``BYTES`` are the registry's own groups, and each byte
function of K1-K3 and of the BatchNorm training op's kernels gives the
bytes of the operands that the kernel's plain version reads and writes.
"""
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import kernels as K
from repro_torch import trace as T
from repro_torch.core import engine as E
from repro_torch.core import round as RD
from repro_torch.data import make_synthetic_cifar, partition_positive_labels
from repro_torch.kernels.bn_act import kernel as bn_k, ref as bn_ref
from repro_torch.kernels.collector_permute import kernel as perm_k
from repro_torch.kernels.collector_permute import ref as perm_ref
from repro_torch.kernels.softmax_xent import kernel as xent_k
from repro_torch.kernels.softmax_xent import ref as xent_ref
from repro_torch.models import resnet as R
from repro_torch.models.common import ComputePolicy
from repro_torch.nn import norm
from repro_torch.optim import sgd_momentum
from repro_torch.tree import tree_leaves

CLIENTS, BATCH, STEPS, HW, WIDTH = 3, 4, 2, 8, 4
# ResNet-8: the client's BN, and 8 in the server (2 + 3 + 3, with the two
# projections); the client's runs twice a step (forward and re-forward)
BN_CALLS = 1 + 8 + 1
PHASES = ("sfpl.perm", "sfpl.client_fwd", "sfpl.server_fwd",
          "sfpl.server_bwd", "sfpl.client_upd")


def _world():
    cfg = R.ResNetConfig(depth=8, num_classes=CLIENTS, width=WIDTH)
    g = torch.Generator().manual_seed(3)
    tx, ty, _, _ = make_synthetic_cifar(g, num_classes=CLIENTS,
                                        train_per_class=BATCH * STEPS,
                                        test_per_class=1, hw=HW)
    data = partition_positive_labels(tx, ty, CLIENTS)
    opt = sgd_momentum(0.05, momentum=0.9, weight_decay=5e-4)
    st = E.init_dcml_state(g, lambda k: R.init(k, cfg), CLIENTS, opt, opt)
    split = E.make_resnet_split(cfg, policy=ComputePolicy(
        "bfloat16", use_fused_kernels=True))
    return st, data, split, opt


def _round(st, data, split, opt):
    return RD.sfpl_round(
        torch.Generator().manual_seed(11), st, data, split, opt, opt,
        num_clients=CLIENTS, batch_size=BATCH,
        collector=RD.DenseTake(CLIENTS, use_kernel=True), device="cpu")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """One round under the profiler: ``(rows, plain, traced, training BN
    calls)``, the rows being the trace's ``sfpl.*``, ``collector.*``,
    ``optim.*`` and ``bn.*`` events."""
    st, data, split, opt = _world()
    plain = _round(st, data, split, opt)
    calls = []
    stats = norm._stats

    def counted(*args, **kwargs):
        calls.append(kwargs["training"])
        return stats(*args, **kwargs)
    norm._stats = counted
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = _round(st, data, split, opt)
    finally:
        norm._stats = stats
    path = tmp_path_factory.mktemp("trace") / "round.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    rows = [e for e in events if e.get("ph") == "X" and e["name"].startswith(
        ("sfpl.", "collector.", "optim.", "bn."))]
    return rows, plain, out, sum(calls)


def _inside(row, outer):
    return outer["ts"] <= row["ts"] and \
        row["ts"] + row["dur"] <= outer["ts"] + outer["dur"]


@pytest.mark.parametrize("name,per_step", [
    *[(p, 1) for p in PHASES], ("collector.permute", 2), ("optim.sgd", 2),
    ("bn.stats", BN_CALLS), ("bn.act", BN_CALLS)])
def test_each_step_nests_its_phases(traced, name, per_step):
    rows = traced[0]
    steps = [r for r in rows if r["name"] == "sfpl.step"]
    assert len(steps) == STEPS
    named = [r for r in rows if r["name"] == name]
    for step in steps:
        assert sum(_inside(r, step) for r in named) == per_step
    assert len(named) == STEPS * per_step


@pytest.mark.parametrize("name", ["sfpl.round", "sfpl.fedavg"])
def test_one_round_span_and_one_fedavg_a_round(traced, name):
    rows = traced[0]
    (one,) = [r for r in rows if r["name"] == name]
    (rnd,) = [r for r in rows if r["name"] == "sfpl.round"]
    assert _inside(one, rnd)
    steps = [r for r in rows if r["name"] == "sfpl.step"]
    if name == "sfpl.fedavg":
        assert not any(_inside(one, s) for s in steps)
    assert all(_inside(s, rnd) for s in steps)


def test_bn_stats_once_for_each_training_bn_call(traced):
    rows, _, _, training_calls = traced
    assert training_calls == STEPS * BN_CALLS
    assert sum(r["name"] == "bn.stats" for r in rows) == training_calls


@pytest.mark.parametrize("part", [0, 1])
def test_profiler_changes_nothing_computed(traced, part):
    _, plain, out, _ = traced
    a, b = tree_leaves(plain[part]), tree_leaves(out[part])
    assert len(a) == len(b)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_without_a_profiler_no_span_reaches_the_recorder(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name!r} recorded with no profiler")
    monkeypatch.setattr(T, "_Record", refuse)
    st, data, split, opt = _world()
    _, losses = _round(st, data, split, opt)
    assert losses.shape == (STEPS,)
    with pytest.raises(AssertionError):
        with profile(activities=[ProfilerActivity.CPU]):
            with T.span("sfpl.step"):
                pass


@pytest.mark.parametrize("key,want", [
    ("steps", STEPS),
    # the bf16 smashed pool, (rows, 8, 8, width), gathered once a step
    ("permuted_bytes", STEPS * CLIENTS * BATCH * HW * HW * WIDTH * 2)])
def test_sfpl_counters_count_the_round(key, want):
    st, data, split, opt = _world()
    T.reset()
    _round(st, data, split, opt)
    assert T.COUNTERS["sfpl"][key] == want
    T.reset()
    assert T.COUNTERS["sfpl"][key] == 0


def test_launches_are_the_registry_group():
    assert K.LAUNCHES is T.COUNTERS["launches"]
    assert K.BYTES is T.COUNTERS["bytes"]
    assert set(K.BYTES) == {"collector_permute", "bn_act", "bn_moments",
                            "bn_grad", "xent_fwd", "xent_bwd"} \
        <= set(K.LAUNCHES)


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _k1():
    x = torch.randn(12, 4, 4, 3).bfloat16()
    perm = torch.randperm(12)
    row = x[0].numel() * x.element_size()
    return perm_k.gather_bytes(12, row, perm.element_size()), \
        _nbytes(x, perm, perm_ref.collector_permute(x, perm))


def _k2():
    x = torch.randn(3, 20, 16).bfloat16()
    a, b = torch.rand(3, 16), torch.randn(3, 16)
    return bn_k.bn_act_bytes(x.numel(), x.element_size(), 3, 16), \
        _nbytes(x, a, b, bn_ref.bn_act(x, a, b))


def _bn_train(training=True):
    x = torch.randn(3, 20, 16).bfloat16()
    vectors = [torch.rand(3, 16) for _ in range(4)]   # scale bias mean var
    run_count = torch.zeros(3)
    stats, new = bn_ref.bn_moments(x, *vectors, run_count, momentum=0.9,
                                   eps=1e-5, training=training)
    _, _, parts, _ = bn_k.stat_geometry(3, 20, 16, 2, True, 132)
    return x, vectors, run_count, stats, new, parts


def _bn_moments(training):
    x, (scale, bias, mean, var), count, stats, new, parts = _bn_train(
        training)
    work = torch.empty(3 * parts * (2 * 16 + 1) + 3)       # partials, tickets
    run = [mean, var, count, *new] if training else []
    return bn_k.bn_moments_bytes(x.numel(), 2, 3, 16, parts, training), \
        _nbytes(x, scale, bias, stats, work, work, *run)


def _k2m():
    return _bn_moments(True)


def _k2m_cmsd():
    return _bn_moments(False)


def _k2g():
    x, _, _, stats, _, parts = _bn_train()
    gy = torch.randn_like(x)
    dx, dscale, dbias = bn_ref.bn_grad(gy, x, stats, relu=True)
    work = torch.empty(3 * parts * 2 * 16 + 3)             # partials, tickets
    coef = torch.empty(2, 3, 16)                  # sum(g) / N, its var term
    return bn_k.bn_grad_bytes(x.numel(), 2, 3, 16, parts), \
        _nbytes(gy, x, stats[[0, 2, 3, 4]], work, work, coef, coef, dx,
                dscale, dbias)


def _xent():
    x = torch.randn(10, 7).bfloat16()
    lab = torch.randint(0, 7, (10,))
    nll, lse = xent_ref.xent_fwd(x, lab)
    return x, lab, nll, lse, torch.rand(10)


def _k3f():
    x, lab, nll, lse, _ = _xent()
    return xent_k.xent_fwd_bytes(10, 7, x.element_size()), \
        _nbytes(x, lab, nll.float(), lse.float())


def _k3b():
    x, lab, _, lse, g = _xent()
    return xent_k.xent_bwd_bytes(10, 7, x.element_size()), \
        _nbytes(x, lab, lse.float(), g, xent_ref.xent_bwd(x, lab, lse, g))


@pytest.mark.parametrize("launch", [_k1, _k2, _k3f, _k3b, _k2m, _k2m_cmsd,
                                    _k2g],
                         ids=["K1", "K2", "K3f", "K3b", "bn_moments",
                              "bn_moments_cmsd", "bn_grad"])
def test_byte_functions_count_the_launch_operands(launch):
    """Every operand read once and every output written once, at the
    dtypes the launchers take: bf16 rows and logits, int64 indices and
    labels, f32 affine, moments and row scales; the BatchNorm kernels'
    partials and tickets written and read once."""
    counted, operands = launch()
    assert counted == operands
