"""The port's sharded SFPL epoch on 2 and 4 gloo ranks (CPU processes)
against the single-device JAX oracle.

The oracle is ``repro.core.round.sfpl_round`` with a ``DenseTake`` (the
body of ``repro.core.engine.sfpl_epoch``) on one device: the JAX mesh
path does not run on the installed jax (ROADMAP section 3). It is fed the
permutations the ranks draw: the test replays the port's collector draws
(``MeshAllToAll.make_perm`` from the same seeded generator) and a
test-local JAX collector hands step ``k``'s permutation to the scan. State
and data come from the JAX package through numpy.

Each world size runs every case in one launch of ``world`` worker
processes (``tests/_torch_mesh_worker.py``), each test reading its case.
Every launch has a ``FileStore`` of its own under a temporary directory
(the suite runs under xdist) and a time limit.

Tolerances, the reference's own: f32 losses and final state <= 1e-5; a
bf16 wire <= 5e-3 and an int8 wire <= 1.5e-2 in epoch loss against the
same f32 oracle (tests/test_wire_dtype.py), the fp8 wire held to the int8
bound (the reference states none for it); bf16 compute <= 1e-2 in loss
(tests/test_compute_policy.py). Against a JAX oracle whose shuffle
applies the JAX package's per-row wire quantization (straight-through
gradient), each wire's epoch matches at the f32 1e-5. The exchange itself
is bitwise: rows, labels and routed-back gradients equal a gather by the
permutation, with the JAX package's own wire quantization.
"""
import dataclasses
import functools
import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import collector_dist as JCD
from repro.core import engine as JE
from repro.core import round as JRD
from repro.core import wire as JW
from repro.models import resnet as JR
from repro.optim import sgd_momentum as j_sgd
from repro_torch.convert import to_numpy
from repro_torch.core import round as TRD
from repro_torch.data import make_synthetic_cifar, partition_positive_labels
from repro_torch.models import resnet as TR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_mesh_worker.py")
N, BATCH, STEPS, HW, WIDTH, LR = 8, 8, 2, 8, 8, 0.05
KEY = jax.random.PRNGKey(7)
TOL_WIRE = {"bfloat16": 5e-3, "int8": 1.5e-2, "float8_e4m3": 1.5e-2}
MASK = np.array([1, 0, 1, 1, 1, 1, 0, 1], bool)
CLIENT_KEYS = ("cp", "cbn", "copt")

# (name, case) run at both world sizes
EPOCHS = {
    "balanced-a1": dict(mode="balanced", alpha=1.0),
    "balanced-a0.5": dict(mode="balanced", alpha=0.5),
    "uniform-a1": dict(mode="uniform", alpha=1.0),
    "uniform-a0.5": dict(mode="uniform", alpha=0.5),
    "masked": dict(mode="balanced", alpha=0.5, participation=MASK),
    "wire-bfloat16": dict(mode="balanced", alpha=1.0, wire="bfloat16"),
    "wire-int8": dict(mode="uniform", alpha=0.5, wire="int8"),
    "wire-float8_e4m3": dict(mode="balanced", alpha=0.5,
                             wire="float8_e4m3", wire_bwd="float8_e4m3"),
    "bf16-compute": dict(mode="balanced", alpha=1.0,
                         compute_dtype="bfloat16"),
}
EXCHANGES = [(mode, wire, dtype)
             for mode in ("balanced", "uniform")
             for wire, dtype in ((None, "float32"), ("bfloat16", "float32"),
                                 ("int8", "float32"), ("int8", "bfloat16"),
                                 ("float8_e4m3", "float32"))]


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.cache
def _world():
    """JAX config, data and initial state (numpy, the JAX package's
    layout): 8 clients, one class each, 2 local steps of batch 8, ResNet-8
    width 8 on 8x8 images. Data and weights are drawn by the port (the
    JAX package's own draws would need a jit of their own) and carried
    over with ``repro_torch.convert.to_numpy``."""
    cfg = JR.ResNetConfig(depth=8, num_classes=N, width=WIDTH)
    gen = torch.Generator().manual_seed(0)
    tx, ty, _, _ = make_synthetic_cifar(gen, num_classes=N,
                                        train_per_class=STEPS * BATCH,
                                        test_per_class=1, hw=HW)
    data = {k: v.numpy() for k, v in
            partition_positive_labels(tx, ty, N).items()}
    params, state = TR.init(gen, TR.ResNetConfig(depth=8, num_classes=N,
                                                 width=WIDTH))
    init = (to_numpy(params), to_numpy(state))
    opt = j_sgd(LR, momentum=0.9, weight_decay=5e-4)
    st = _host(JE.init_dcml_state(None, lambda k: init, N, opt, opt))
    return cfg, data, st


def _seed(name):
    return 11 + list(EPOCHS).index(name)


def _port_perms(world, case, seed):
    """The permutations the ranks draw: the port's collector from a
    generator seeded like theirs (``make_perm`` reads only the layout)."""
    coll = TRD.DataGroup(None, 0, world).collector(
        N, alpha=case["alpha"], mode=case["mode"])
    gen = torch.Generator().manual_seed(seed)
    return np.stack([coll.make_perm(gen, N * BATCH).numpy()
                     for _ in range(STEPS)])


def _through_wire(x, wire):
    """The rows as they arrive over ``wire``: the JAX package's per-row
    quantize-dequantize, or the bf16 cast."""
    if wire is None or (wire == "bfloat16" and x.dtype == jnp.bfloat16):
        return x
    if wire == "bfloat16":
        return x.astype(jnp.bfloat16).astype(x.dtype)
    q, s = JW.quantize_rows(x.reshape(x.shape[0], -1), wire)
    return JW.dequantize_rows(q, s, x.dtype).reshape(x.shape)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3))
def _wire_take(x, perm, wire, wire_bwd):
    return _through_wire(jnp.take(x, perm, axis=0), wire)


def _wire_take_fwd(x, perm, wire, wire_bwd):
    return _wire_take(x, perm, wire, wire_bwd), perm


def _wire_take_bwd(wire, wire_bwd, perm, g):
    # straight-through: the cotangent rows cross the backward wire, then
    # go back by the inverse permutation
    inv = jnp.zeros_like(perm).at[perm].set(jnp.arange(perm.shape[0],
                                                       dtype=perm.dtype))
    return jnp.take(_through_wire(g, wire_bwd), inv, axis=0), None


_wire_take.defvjp(_wire_take_fwd, _wire_take_bwd)


@dataclasses.dataclass(frozen=True)
class _GivenPerms(JRD.DenseTake):
    """DenseTake whose step ``k`` permutation is ``perms[k]``: the scan's
    per-step key is matched against the replayed keys ``kperms``. With
    ``wire`` / ``wire_bwd`` set, float rows cross the wire's per-row
    quantization (the JAX package's ``core.wire``) with the straight-
    through gradient, as the sharded exchange defines it."""
    perms: object = None
    kperms: object = None
    wire: object = None
    wire_bwd: object = None

    def make_perm(self, key, n):
        hit = jnp.all(self.kperms == key[None], axis=1)
        return self.perms[jnp.argmax(hit)]

    def permute(self, x, prep):
        if not jnp.issubdtype(x.dtype, jnp.floating) or (
                self.wire is None and self.wire_bwd is None):
            return super().permute(x, prep)
        return _wire_take(x, prep.perm, self.wire, self.wire_bwd)


def _kperms():
    key, out = KEY, []
    for _ in range(STEPS):
        key, kperm = jax.random.split(key)
        out.append(kperm)
    return jnp.stack(out)


@functools.cache
def _oracle_fn(masked, wire=None, wire_bwd=None):
    cfg, _, _ = _world()
    split = JE.make_resnet_split(cfg)
    opt = j_sgd(LR, momentum=0.9, weight_decay=5e-4)

    def run(st, data, perms, kperms, mask):
        return JRD.sfpl_round(
            KEY, st, data, split, opt, opt, num_clients=N, batch_size=BATCH,
            collector=_GivenPerms(N, perms=perms, kperms=kperms, wire=wire,
                                  wire_bwd=wire_bwd),
            participation=mask if masked else None)
    return jax.jit(run)


def _oracle(perms, mask=None, wire=None, wire_bwd=None):
    """The single-device JAX epoch on ``perms``; with a wire, the
    exchange's per-row wire semantics applied to the shuffle."""
    _, data, st0 = _world()
    st, losses = _oracle_fn(mask is not None, wire, wire_bwd)(
        st0, data, jnp.asarray(perms, jnp.int32), _kperms(),
        None if mask is None else jnp.asarray(mask))
    return np.asarray(losses), _host(st)


def _exchange_case(world, mode, wire, dtype, i):
    rng = np.random.default_rng(100 + i)
    n = N * BATCH
    coll = TRD.DataGroup(None, 0, world).collector(N, mode=mode)
    perm = coll.make_perm(torch.Generator().manual_seed(i), n).numpy()
    x = (rng.standard_normal((n, 2, 2, 3)) * 2).astype(np.float32)
    x[5] = 0.0                                         # an all-zero row
    return dict(kind="exchange", mode=mode, wire=wire, dtype=dtype,
                wire_bwd="int8" if wire == "int8" else None, perm=perm,
                x=x, w=rng.standard_normal(x.shape).astype(np.float32),
                labels=rng.integers(0, 10, n))


class _Launch:
    """``world`` worker processes running ``cases``; ``results`` waits for
    them (killing all and failing past ``timeout`` seconds from the
    start) and returns each rank's results."""

    def __init__(self, tmp, world, cases, timeout):
        _, data, st0 = _world()
        job = dict(world=world, store=str(tmp / "store"), out=str(tmp),
                   cases=cases, state=st0, data=data, num_clients=N,
                   batch=BATCH, num_classes=N, width=WIDTH, lr=LR)
        with open(tmp / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(ROOT, "src")]
            + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.tmp, self.world, self.cases = tmp, world, cases
        self.deadline = time.monotonic() + timeout
        self.logs = [open(tmp / f"rank{r}.log", "w") for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, str(tmp / "job.pkl"), str(r)], env=env,
            stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]

    def results(self):
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pytest.fail(f"{self.world}-rank launch did not finish in time")
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in self.logs:
                f.close()
        out = []
        for r, p in enumerate(self.procs):
            log = (self.tmp / f"rank{r}.log").read_text()
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
            with open(self.tmp / f"rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every case at world sizes 2 and 4, both launches running at once
    while the JAX oracles of their epochs are computed here."""
    launches = {}
    for world in (2, 4):
        cases = [dict(kind="epoch", seed=_seed(name), **case)
                 for name, case in EPOCHS.items()]
        cases += [_exchange_case(world, *spec, i)
                  for i, spec in enumerate(EXCHANGES)]
        launches[world] = _Launch(tmp_path_factory.mktemp(f"mesh{world}"),
                                  world, cases, timeout=150)
    oracles = {}
    for world in (2, 4):
        for name, case in EPOCHS.items():
            perms = _port_perms(world, case, _seed(name))
            oracles[world, name] = _oracle(perms, case.get("participation"))
            if "wire" in case:
                oracles[world, name, "wire"] = _oracle(
                    perms, wire=case["wire"], wire_bwd=case.get("wire_bwd"))
    return {w: (launch.cases, launch.results(), oracles)
            for w, launch in launches.items()}


def _result(mesh_runs, world, index):
    cases, ranks, _ = mesh_runs[world]
    res = [r[index] for r in ranks]
    for rank, r in enumerate(res):
        assert "ok" in r, f"rank {rank}:\n{r.get('error')}"
    return cases[index], [r["ok"] for r in res]


def _oracle_of(mesh_runs, world, name, *wire):
    return mesh_runs[world][2][(world, name) + wire]


def _merged_state(ranks):
    """Client leaves concatenated in rank order; server leaves must agree
    on every rank (they are replicated)."""
    states = [r["state"] for r in ranks]
    leaves = lambda t: jax.tree_util.tree_leaves(t)
    for k in ("sp", "sbn", "sopt", "step"):
        for other in states[1:]:
            for u, v in zip(leaves(states[0][k]), leaves(other[k])):
                np.testing.assert_allclose(v, u, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{k} differs by rank")
    merged = dict(states[0])
    for k in CLIENT_KEYS:
        merged[k] = jax.tree_util.tree_map(
            lambda *xs: np.concatenate(xs), *[s[k] for s in states])
    return merged


def _assert_state(st_t, st_j, tol=1e-5):
    for k in CLIENT_KEYS + ("sp", "sbn", "sopt", "step"):
        a = jax.tree_util.tree_leaves(st_t[k])
        b = jax.tree_util.tree_leaves(st_j[k])
        assert len(a) == len(b), k
        for u, v in zip(a, b):
            np.testing.assert_allclose(u, v, rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["balanced-a1", "balanced-a0.5",
                                  "uniform-a1", "uniform-a0.5", "masked"])
def test_sharded_epoch_matches_jax_oracle(mesh_runs, world, name):
    case, ranks = _result(mesh_runs, world, list(EPOCHS).index(name))
    losses_j, st_j = _oracle_of(mesh_runs, world, name)
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses_j, rtol=1e-5,
                                   atol=1e-5)
    _assert_state(_merged_state(ranks), st_j)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("wire", ["bfloat16", "int8", "float8_e4m3"])
def test_sharded_wire_epoch_within_wire_bound(mesh_runs, world, wire):
    name = f"wire-{wire}"
    case, ranks = _result(mesh_runs, world, list(EPOCHS).index(name))
    losses_j, _ = _oracle_of(mesh_runs, world, name)
    gap = np.abs(ranks[0]["losses"] - losses_j).max()
    assert gap <= TOL_WIRE[wire], (wire, gap)
    assert gap > 0.0, "a narrow wire changed nothing: it did not run"


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("wire", ["bfloat16", "int8", "float8_e4m3"])
def test_sharded_wire_epoch_matches_jax_wire_semantics(mesh_runs, world,
                                                       wire):
    """Exactly (1e-5, f32) the JAX oracle whose shuffle applies the JAX
    package's per-row wire quantization with the straight-through
    gradient (and, for fp8, the same on the gradient rows): the sharded
    wire is the reference's wire semantics, not merely close to f32."""
    name = f"wire-{wire}"
    case, ranks = _result(mesh_runs, world, list(EPOCHS).index(name))
    losses_j, st_j = _oracle_of(mesh_runs, world, name, "wire")
    np.testing.assert_allclose(ranks[0]["losses"], losses_j, rtol=1e-5,
                               atol=1e-5)
    _assert_state(_merged_state(ranks), st_j)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_bf16_compute_loss_within_bound(mesh_runs, world):
    case, ranks = _result(mesh_runs, world,
                          list(EPOCHS).index("bf16-compute"))
    losses_j, _ = _oracle_of(mesh_runs, world, "bf16-compute")
    assert np.abs(ranks[0]["losses"] - losses_j).max() <= 1e-2
    assert all(a.dtype == np.float32
               for a in jax.tree_util.tree_leaves(ranks[0]["state"]["sp"]))


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("spec", EXCHANGES,
                         ids=[f"{m}-{w}-{d}" for m, w, d in EXCHANGES])
def test_plan_shuffle_is_the_permutation(mesh_runs, world, spec):
    """Every rank's slab of the exchanged pool is its slab of ``x[perm]``
    (through the wire, quantized by the JAX package's own wire code), the
    labels ride the same plan exactly, the gradient comes back through
    the backward plan, and the exchange's byte count is the JAX
    package's for the same plan."""
    index = len(EPOCHS) + EXCHANGES.index(spec)
    case, ranks = _result(mesh_runs, world, index)
    perm, x, w = case["perm"], case["x"], case["w"]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[case["dtype"]]
    inv = np.argsort(perm)

    def through(rows, wire):
        r = jnp.asarray(rows).astype(jdt)
        if wire in ("int8", "float8_e4m3"):
            q, s = JW.quantize_rows(r.reshape(r.shape[0], -1), wire)
            r = JW.dequantize_rows(q, s, jdt).reshape(r.shape)
        elif wire == "bfloat16" and jdt != jnp.bfloat16:
            r = r.astype(jnp.bfloat16).astype(jdt)
        return np.asarray(r.astype(jnp.float32))

    want = through(x[perm], case["wire"])
    w_out = np.asarray(jnp.asarray(w).astype(jdt).astype(jnp.float32))
    g_want = through(w_out, case["wire_bwd"])[inv]
    b = x.shape[0] // world
    mt = TRD.DataGroup(None, 0, world).collector(N, mode=case["mode"])
    cap, may_drop = mt.plan_spec(x.shape[0])
    jplan, _ = JCD.build_route_plans(jnp.asarray(perm), world, cap=cap,
                                     may_drop=may_drop)
    bytes_j = JCD.plan_payload_bytes(
        jplan, 12, jnp.dtype(jdt).itemsize,
        wire_dtype=JCD._resolve_wire(jnp.dtype(jdt), case["wire"]))
    for rank, r in enumerate(ranks):
        sl = slice(rank * b, (rank + 1) * b)
        np.testing.assert_array_equal(r["out"], want[sl])
        np.testing.assert_array_equal(r["labels"], case["labels"][perm][sl])
        np.testing.assert_array_equal(r["grad"], g_want[sl])
        assert r["bytes"] == bytes_j


def test_overflow_raises_on_every_rank(tmp_path):
    """Uniform buckets forced too small, with the capacity check on: the
    plan's replicated overflow count raises on every rank at the same
    point, before the collective, so no rank hangs (the launch has a time
    limit of its own)."""
    case = dict(kind="overflow", seed=5, mode="uniform", alpha=1.0,
                slack=0.0, check_capacity=True)
    ranks = _Launch(tmp_path, 2, [case], timeout=90).results()
    for rank, res in enumerate(ranks):
        err = res[0].get("error", "")
        assert "RuntimeError: collector exchange dropped" in err, (rank, res)

