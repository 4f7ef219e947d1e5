"""The port's streaming collector, sub-mesh routing, pods and sharded
SFLv2 (``core/collector_dist.py``, ``core/round.py``,
``core/engine_dist.py``) against the JAX package.

Host-side pieces (slice sizes, the probed slack, the sub-mesh plans) are
compared with the JAX functions directly. The epochs run on 2 and 4 gloo
ranks (``tests/_torch_mesh_worker.py``, launched as
``tests/test_torch_mesh.py`` launches it) and are held against the
single-device JAX oracle of that file, fed the permutations the ranks
draw: the JAX mesh path does not run on the installed jax (ROADMAP
section 3), and the streamed pool is row for row the sync pool, so the
single-device oracle applies. The exchange bytes are the JAX
``StreamingAllToAll``'s for the same permutation, its plans built on a
stand-in mesh object that has only the mesh's shape.

Tolerances, the reference's own: f32 losses and final state <= 1e-5; an
int8 forward wire <= 1.5e-2 in loss against the f32 oracle
(tests/test_wire_dtype.py). Streamed against the port's sync epoch on the
same generator: equal losses, exactly.
"""
import logging
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collector_dist as JCD
from repro.core import engine as JE
from repro.core import round as JRD
from repro.optim import sgd_momentum as j_sgd
from repro_torch.core import collector_dist as TCD
from repro_torch.core import round as TRD
from repro_torch.core import engine_dist as TED

from test_torch_mesh import (BATCH, LR, N, TOL_WIRE, _Launch, _assert_state,
                             _host, _merged_state, _oracle, _world)

# flush group 1 (clients 4-7 at alpha 0.5) all out, and client 2. With
# only clients 0, 2 and 3 left the JAX oracle itself spreads by 4.6e-4 in
# momentum over permutations that leave the math unchanged (ill-
# conditioned there); with 0, 1 and 3 it holds to 2.5e-7
SKIP_MASK = np.array([1, 1, 0, 1, 0, 0, 0, 0], bool)
STREAMS = {
    "sub-a1": dict(mode="balanced", alpha=1.0),
    "sub-a0.5": dict(mode="balanced", alpha=0.5),
    "sub-a0.25": dict(mode="balanced", alpha=0.25),
    "fallback-a1": dict(mode="balanced", alpha=1.0, submesh=False),
    "fallback-a0.5": dict(mode="balanced", alpha=0.5, submesh=False),
    "fallback-a0.25": dict(mode="balanced", alpha=0.25, submesh=False),
    "uniform-a1": dict(mode="uniform", alpha=1.0),
    "uniform-a0.5": dict(mode="uniform", alpha=0.5),
    "uniform-a0.25": dict(mode="uniform", alpha=0.25),
    "skip-sub": dict(mode="balanced", alpha=0.5, participation=SKIP_MASK),
    "skip-fallback": dict(mode="balanced", alpha=0.5, submesh=False,
                          participation=SKIP_MASK),
    "int8-sub": dict(mode="balanced", alpha=0.5, wire="int8"),
    "int8-fallback": dict(mode="uniform", alpha=0.5, wire="int8"),
}
# 4 ranks only: 2 pods of 2 keep the alpha-0.5 slices of 2 inside a pod;
# 4 pods of 1 make them straddle, so the epoch takes the fallback
PODS = {
    "pods2-a0.5": dict(mode="balanced", alpha=0.5, pods=2),
    "pods4-a0.5": dict(mode="balanced", alpha=0.5, pods=4),
}
SHUFFLES = [("balanced", 1.0, None), ("balanced", 0.5, None),
            ("balanced", 0.5, False), ("balanced", 0.25, None),
            ("uniform", 0.25, None)]
SFLV2_CLIENTS, SFLV2_STEPS = 2, 1
SFLV2_KEY = jax.random.PRNGKey(3)


def _streams(world):
    return dict(STREAMS, **(PODS if world == 4 else {}))


def _seed(name):
    return 40 + sorted(set(STREAMS) | set(PODS)).index(name)


def _perms(world, case, seed, steps=2):
    coll = TRD.DataGroup(None, 0, world).collector(
        N, alpha=case["alpha"], mode=case["mode"],
        pipeline="double_buffered")
    gen = torch.Generator().manual_seed(seed)
    return np.stack([coll.make_perm(gen, N * BATCH).numpy()
                     for _ in range(steps)])


def _shuffle_case(world, mode, alpha, submesh, i):
    n = N * BATCH
    coll = TRD.DataGroup(None, 0, world).collector(
        N, alpha=alpha, mode=mode, pipeline="double_buffered",
        submesh=submesh)
    perm = coll.make_perm(torch.Generator().manual_seed(70 + i), n).numpy()
    x = np.random.default_rng(i).uniform(0.5, 1.5, (n, 3)).astype(
        np.float32)
    return dict(kind="shuffle", mode=mode, alpha=alpha, submesh=submesh,
                perm=perm, x=x)


def _sflv2_order():
    return np.asarray(jax.random.permutation(SFLV2_KEY,
                                             SFLV2_CLIENTS)).tolist()


def _sflv2_oracle():
    cfg, data, st0 = _world()
    cut = lambda t: jax.tree_util.tree_map(lambda a: a[:SFLV2_CLIENTS], t)
    st0 = dict(st0, **{k: cut(st0[k]) for k in ("cp", "cbn", "copt")})
    data = {k: v[:SFLV2_CLIENTS, :SFLV2_STEPS * BATCH]
            for k, v in data.items()}
    split = JE.make_resnet_split(cfg)
    opt = j_sgd(LR, momentum=0.9, weight_decay=5e-4)
    st, losses = jax.jit(lambda k, s, d: JE.sflv2_epoch(
        k, s, d, split, opt, opt, num_clients=SFLV2_CLIENTS,
        batch_size=BATCH))(SFLV2_KEY, st0, data)
    return np.asarray(losses), _host(st)


class _Mesh:
    """What the JAX collector reads of a mesh: its axis names and shape."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _jax_streaming(world, case):
    pods = case.get("pods")
    if pods is None:
        mesh, axis = _Mesh((world,), ("data",)), "data"
    else:
        mesh = _Mesh((pods, world // pods), ("pod", "data"))
        axis = ("pod", "data")
    return JRD.StreamingAllToAll(mesh=mesh, num_clients=N, axis=axis,
                                 mode=case["mode"], alpha=case["alpha"],
                                 submesh=case.get("submesh"),
                                 wire_dtype=case.get("wire"))


@pytest.fixture(scope="module")
def stream_runs(tmp_path_factory):
    """Every case at world sizes 2 and 4, both launches running at once
    while the JAX oracles are computed here."""
    launches = {}
    for world in (2, 4):
        names = list(_streams(world))
        cases = [dict(kind="stream", seed=_seed(name), **_streams(world)[name])
                 for name in names]
        cases += [_shuffle_case(world, *spec, i)
                  for i, spec in enumerate(SHUFFLES)]
        cases.append(dict(kind="sflv2", order=_sflv2_order(),
                          clients=SFLV2_CLIENTS, steps=SFLV2_STEPS))
        launches[world] = (names, _Launch(
            tmp_path_factory.mktemp(f"stream{world}"), world, cases,
            timeout=150))
    oracles = {"sflv2": _sflv2_oracle()}
    for world in (2, 4):
        for name, case in _streams(world).items():
            perms = _perms(world, case, _seed(name))
            oracles[world, name] = _oracle(perms, case.get("participation"))
            if "wire" in case:
                oracles[world, name, "wire"] = _oracle(perms,
                                                       wire=case["wire"])
    return {w: (names, launch.cases, launch.results(), oracles)
            for w, (names, launch) in launches.items()}


def _result(stream_runs, world, index):
    _, cases, ranks, _ = stream_runs[world]
    res = [r[index] for r in ranks]
    for rank, r in enumerate(res):
        assert "ok" in r, f"rank {rank}:\n{r.get('error')}"
    return cases[index], [r["ok"] for r in res]


def _stream_result(stream_runs, world, name):
    names = stream_runs[world][0]
    return _result(stream_runs, world, names.index(name))


ALL = [(w, name) for w in (2, 4) for name in _streams(w)]
EXACT = [(w, name) for w, name in ALL if "int8" not in name]


@pytest.mark.parametrize("world,name", EXACT,
                         ids=[f"{w}-{n}" for w, n in EXACT])
def test_streamed_epoch_matches_jax_oracle(stream_runs, world, name):
    """The double-buffered epoch (sub-mesh or whole-group fallback, at
    alpha 1.0, 0.5 and 0.25, uniform, a dropped flush group, pods): the
    single-device JAX oracle's losses and final state within 1e-5."""
    case, ranks = _stream_result(stream_runs, world, name)
    losses_j, st_j = stream_runs[world][3][world, name]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses_j, rtol=1e-5,
                                   atol=1e-5)
    _assert_state(_merged_state(ranks), st_j)


@pytest.mark.parametrize("world,name", ALL,
                         ids=[f"{w}-{n}" for w, n in ALL])
def test_streamed_losses_equal_sync(stream_runs, world, name):
    """Streamed and sync epochs from one generator: the same losses,
    exactly (the streamed pool is row for row the sync pool, and the
    routed-back gradients are the sync backward's)."""
    case, ranks = _stream_result(stream_runs, world, name)
    for r in ranks:
        np.testing.assert_array_equal(r["losses"], r["sync"])


@pytest.mark.parametrize("world,name", ALL,
                         ids=[f"{w}-{n}" for w, n in ALL])
def test_streamed_bytes_and_routing_match_jax(stream_runs, world, name):
    """The exchange bytes of a step are the JAX ``StreamingAllToAll``'s
    ``exchange_bytes`` for the same permutation, and the port routes the
    layout as JAX does (sub-mesh slice size or the fallback). The
    fallback's re-layouts, which the JAX package leaves to GSPMD, are
    counted apart and vanish where the fine slabs are the home slabs."""
    case, ranks = _stream_result(stream_runs, world, name)
    n = N * BATCH
    logging.disable(logging.WARNING)
    try:
        jcoll = _jax_streaming(world, case)
        jprep = jcoll.prepare(jnp.asarray(ranks[0]["perm"]), n)
        slices = jcoll.submesh_slices(n)
    finally:
        logging.disable(logging.NOTSET)
    row = 8 * 8 * 8
    want = jcoll.exchange_bytes(jprep, row, jnp.float32)
    for r in ranks:
        assert r["submesh"] == slices
        assert r["bytes"] == want
        if slices is not None or (case["alpha"] == 1.0):
            assert r["relayout_bytes"] == 0
        else:
            assert r["relayout_bytes"] > 0
    if name == "pods4-a0.5":
        assert slices is None                 # straddles: the fallback
    if name == "pods2-a0.5":
        assert slices == 2                    # pod-local


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["int8-sub", "int8-fallback"])
def test_streamed_int8_wire(stream_runs, world, name):
    """An int8 forward wire: within 1.5e-2 of the f32 oracle, and within
    1e-5 of the oracle whose shuffle applies the JAX package's per-row
    quantization (straight-through gradient)."""
    case, ranks = _stream_result(stream_runs, world, name)
    losses_j, _ = stream_runs[world][3][world, name]
    gap = np.abs(ranks[0]["losses"] - losses_j).max()
    assert 0.0 < gap <= TOL_WIRE["int8"], gap
    losses_w, st_w = stream_runs[world][3][world, name, "wire"]
    np.testing.assert_allclose(ranks[0]["losses"], losses_w, rtol=1e-5,
                               atol=1e-5)
    _assert_state(_merged_state(ranks), st_w)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("spec", SHUFFLES,
                         ids=[f"{m}-a{a}-{s}" for m, a, s in SHUFFLES])
def test_streamed_shuffle_is_the_permutation(stream_runs, world, spec):
    """``streamed_shuffle`` gives every rank its slab of ``x[perm]``, row
    for row, the last (drained) flush group's rows included, and
    ``route_back`` returns ``x``."""
    names = stream_runs[world][0]
    case, ranks = _result(stream_runs, world,
                          len(names) + SHUFFLES.index(spec))
    x, perm = case["x"], case["perm"]
    b = x.shape[0] // world
    want = x[perm]
    for rank, r in enumerate(ranks):
        sl = slice(rank * b, (rank + 1) * b)
        np.testing.assert_array_equal(r["out"], want[sl])
        np.testing.assert_array_equal(r["back"], x[sl])
    out = np.concatenate([r["out"] for r in ranks])
    r0 = TRD.DataGroup(None, 0, world).collector(
        N, alpha=spec[1], mode=spec[0],
        pipeline="double_buffered").group_bounds(x.shape[0])[-1][0]
    assert (out[r0:] > 0).all(), "the drain dropped rows of the last group"


@pytest.mark.parametrize("world", [2, 4])
def test_sflv2_sharded_matches_jax(stream_runs, world):
    """``sflv2_epoch_sharded`` (each client's batch split over the ranks,
    JAX's visit order) against JAX's single-device ``sflv2_epoch``: two
    server updates (SFLv2's sequential stream amplifies float-order
    noise, see tests/test_torch_engine.py), losses and state within
    1e-5, every rank with the same state."""
    names = stream_runs[world][0]
    _, ranks = _result(stream_runs, world, len(names) + len(SHUFFLES))
    losses_j, st_j = stream_runs[world][3]["sflv2"]
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses_j, rtol=1e-5,
                                   atol=1e-5)
        _assert_state(r["state"], st_j)


# --------------------------------------------------------------------------
# host-side pieces against the JAX functions

@pytest.mark.parametrize("n,shards,groups,want", [
    (64, 8, [16, 16, 16, 16], 2), (64, 8, [64], 8),
    (64, 8, [32, 16, 16], None), (64, 4, [16, 16, 16, 16], 1),
    (48, 4, [24, 24], 2), (48, 4, [12, 36], None)])
def test_submesh_slice_size_matches_jax(n, shards, groups, want):
    assert TCD.submesh_slice_size(n, shards, groups) == want
    assert JCD.submesh_slice_size(n, shards, groups) == want
    assert TCD.submesh_axis_groups(shards, want or 1) == \
        JCD.submesh_axis_groups(shards, want or 1)


def test_submesh_slice_straddling_a_pod_falls_back(caplog):
    """At 4 ranks in 4 pods the alpha-0.5 slices of 2 ranks straddle a
    pod: auto resolution takes the fallback with a warning, ``True``
    raises, and ``check_sfpl_layout`` agrees with JAX's; in 2 pods the
    same slices stay inside a pod."""
    n = 8 * 8
    straddle = TRD.DataGroup(None, 0, 4, pods=4).collector(
        8, alpha=0.5, pipeline="double_buffered")
    with caplog.at_level(logging.WARNING, logger=TRD.__name__):
        assert straddle.submesh_slices(n) is None
    assert "straddles the pod boundary" in caplog.text
    forced = TRD.DataGroup(None, 0, 4, pods=4).collector(
        8, alpha=0.5, pipeline="double_buffered", submesh=True)
    with pytest.raises(ValueError, match="straddles"):
        forced.submesh_slices(n)
    local = TRD.DataGroup(None, 0, 4, pods=2).collector(
        8, alpha=0.5, pipeline="double_buffered")
    assert local.submesh_slices(n) == 2
    from repro.core import engine_dist as JED
    for pods, submesh in ((4, None), (2, True), (None, True)):
        kw = dict(alpha=0.5, pods=pods, collector_submesh=submesh,
                  collector_pipeline="double_buffered")
        assert TED.check_sfpl_layout(8, 8, 4, **kw) == \
            JED.check_sfpl_layout(8, 8, 4, **kw)
    kw = dict(alpha=0.5, pods=4, collector_submesh=True,
              collector_pipeline="double_buffered")
    with pytest.raises(ValueError) as t_err:
        TED.check_sfpl_layout(8, 8, 4, **kw)
    with pytest.raises(ValueError) as j_err:
        JED.check_sfpl_layout(8, 8, 4, **kw)
    assert str(t_err.value) == str(j_err.value)


@pytest.mark.parametrize("scheme,pipeline,submesh,pods,maxs", [
    ("sfpl", "double_buffered", None, None, 8),
    ("sfpl", "double_buffered", None, 2, 8),
    ("sfpl", "double_buffered", True, 4, 4),
    ("sflv2", "sync", None, None, 6), ("sfpl", "sync", None, 3, 7)])
def test_fit_shards_matches_jax(scheme, pipeline, submesh, pods, maxs):
    from repro.core import engine_dist as JED
    kw = dict(scheme=scheme, alpha=0.5, collector_pipeline=pipeline,
              collector_submesh=submesh, pods=pods, max_shards=maxs)
    assert TED.fit_shards(8, 8, **kw) == JED.fit_shards(8, 8, **kw)


@pytest.mark.parametrize("n,shards,span", [
    (64, 8, 4), (32, 4, 1), (32, 2, 2), (96, 8, 4), (16, 2, 1)])
def test_balanced_stream_slack_matches_jax(n, shards, span):
    """numpy draws from the same seeds: the same value, exactly."""
    assert TCD.balanced_stream_slack(n, shards, span) == \
        JCD.balanced_stream_slack(n, shards, span)
    assert TCD.uniform_auto_slack(n, shards) == \
        JCD.uniform_auto_slack(n, shards)


@pytest.mark.parametrize("n_shards,S,cap", [(4, 2, 1), (4, 2, 3), (8, 4, 2),
                                            (4, 4, 2), (4, 1, 2)])
def test_submesh_route_plans_match_jax(n_shards, S, cap):
    """``build_submesh_route_plans`` on a balanced sub-permutation: the
    JAX package's index arrays and metadata, both directions."""
    b = S * cap
    n_g = S * b
    for g in range(n_shards // S):
        sub = np.array(JCD.make_balanced_perm(
            jax.random.PRNGKey(10 * n_shards + g), n_g, S))
        jplans = JCD.build_submesh_route_plans(jnp.asarray(sub), g,
                                               n_shards, S)
        tplans = TCD.build_submesh_route_plans(torch.from_numpy(sub), g,
                                               n_shards, S)
        for jp, tp in zip(jplans, tplans):
            np.testing.assert_array_equal(tp.send_idx.numpy(),
                                          np.asarray(jp.send_idx))
            np.testing.assert_array_equal(tp.recv_idx.numpy(),
                                          np.asarray(jp.recv_idx))
            assert (tp.n, tp.n_shards, tp.cap, tp.may_drop,
                    tp.slice_size, tp.overflow) == (
                jp.n, jp.n_shards, jp.cap, jp.may_drop, jp.slice_size,
                None)
            assert tp.dense and jp.dense
            for wire in (None, "int8"):
                assert TCD.plan_payload_bytes(tp, 12, 4, wire_dtype=wire) \
                    == JCD.plan_payload_bytes(jp, 12, 4, wire_dtype=wire)


@pytest.mark.parametrize("start,stop,b,world", [
    (0, 32, 32, 2), (32, 64, 32, 2), (0, 16, 16, 4), (16, 48, 16, 4),
    (0, 64, 16, 4), (8, 24, 16, 4)])
def test_relayout_counts_cover_the_group(start, stop, b, world):
    """Every row of the group is counted once: row sums are the home
    slabs' shares, column sums the fine slabs' (n_g / world each)."""
    counts = np.array(TCD.relayout_counts(start, stop, b, world))
    assert counts.sum() == stop - start
    assert (counts.sum(axis=0) == (stop - start) // world).all()
    home = [max(0, min(stop, (h + 1) * b) - max(start, h * b))
            for h in range(world)]
    assert counts.sum(axis=1).tolist() == home


def test_collector_knobs():
    """The collector's knob checks, as the JAX ``DataMesh.collector``'s
    and ``StreamingAllToAll.submesh_slices``'."""
    group = TRD.DataGroup(None, 0, 2)
    with pytest.raises(ValueError, match="double_buffered"):
        group.collector(8, submesh=True)
    with pytest.raises(ValueError, match="pipeline"):
        group.collector(8, pipeline="triple")
    coll = group.collector(8, alpha=0.25, mode="uniform",
                           pipeline="double_buffered", submesh=True)
    with pytest.raises(ValueError, match="balanced"):
        coll.submesh_slices(48)
    slack = group.collector(8, alpha=0.25, pipeline="double_buffered",
                            submesh=True, stream_slack=2.0)
    with pytest.raises(ValueError, match="slack"):
        slack.submesh_slices(48)


LAUNCHES = {
    "eval-submesh": (["eval", "--paper", "--sharded", "--pipeline",
                      "double_buffered", "--submesh", "--alpha", "0.5"],
                     ["matched fleet (8 clients, sharded=True",
                      "sfpl   IID test", "sflv2  IID test"]),
    "train-pods": (["train", "--paper", "--sharded", "--pipeline",
                    "double_buffered", "--pods", "2", "--alpha", "0.5"],
                   ["pipeline=double_buffered, submesh=None, pods=2",
                    "non-IID accuracy"]),
    "train-sflv2": (["train", "--paper", "--sharded", "--scheme", "sflv2"],
                    ["sharded SFLv2: 2 rank(s)", "non-IID accuracy"]),
}


@pytest.mark.parametrize("name", sorted(LAUNCHES))
def test_launchers_under_torchrun(tmp_path, name):
    """The C2 knobs of the launchers under ``torchrun`` on 2 gloo ranks
    (``--standalone``: a free port), one epoch: each runs to its end and
    rank 0 prints its lines once."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args, lines = LAUNCHES[name]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(root, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", f"repro_torch.launch.{args[0]}"]
        + args[1:] + ["--device", "cpu", "--epochs", "1"], env=env,
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    for line in lines:
        assert res.stdout.count(line) == 1, (line, res.stdout)
