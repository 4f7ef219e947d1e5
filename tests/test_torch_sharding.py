"""The port's sharding rules (``repro_torch.sharding``) against the JAX
package's, its constraints, and the sharded LM on a 2x2 gloo mesh.

* Param specs: every leaf of all ten architectures at full width, on the
  (16, 16) and (2, 16, 16) meshes: the port's ``spec_for_param`` on a
  meta-device init against JAX's on ``jax.eval_shape`` of its init (only
  axis names and sizes are read, as ``tests/test_substrate.py``'s stub
  mesh does).
* Batch and decode-state specs: every architecture x shape of ``SHAPES``
  through ``input_specs``; JAX's ``NamedSharding``s are built in one
  subprocess on 512 forced host devices with a real ``jax.make_mesh``
  (shardings only, nothing lowered).
* ``REPRO_MOE_EP=data``: both packages read it at import, so a subprocess
  with it set compares the MoE leaves, and four ranks started with it run
  llama4-scout's prefill and train step through the experts' all-to-all
  layout.
* The sharded LM: four gloo ranks on a 2x2 ``("data", "model")`` mesh
  (``tests/_torch_shard_worker.py``) run prefill, two decode steps and one
  SGD-momentum step (with SFPL's collector permutation for the
  transformer family) of qwen3-8b, llama4-scout (capacity factor = the
  4 experts: no drops), xlstm-1.3b, recurrentgemma-9b and
  whisper-large-v3 at their smoke configs in f32, plus the kernel paths
  (K7's and K8's plain versions on the CPU, through ``local_region``);
  each within 1e-5 of the single-device port on the same params and
  inputs (the single-device port is held against JAX elsewhere).
* Every constraint is the identity without ``mesh_axes`` and on plain
  tensors.
"""
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_arch as j_get_arch
from repro.sharding import rules as JR
from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.configs.registry import input_specs
from repro_torch.models import common as C
from repro_torch.nn import attention as A
from repro_torch.nn import moe as M
from repro_torch.sharding import dtensor as D
from repro_torch.sharding import rules as R
from repro_torch.tree import tree_map_with_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import _torch_shard_worker as W  # noqa: E402

MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16))}


class _StubMesh:
    """What JAX's rules read of a mesh: axis names and sizes."""

    def __init__(self, axes):
        self.axis_names = tuple(a for a, _ in axes)
        self.devices = np.empty(tuple(n for _, n in axes), object)


def _norm(spec):
    """A spec as a comparable tuple: single-name tuples as the name,
    trailing Nones dropped."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else
           (tuple(e) if isinstance(e, (tuple, list)) else e) for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _port_param_specs(arch, axes):
    spec = get_arch(arch)
    with torch.device("meta"):
        params = spec.model.init(None, spec.make_config())
    out = {}
    tree_map_with_path(lambda path, leaf: out.__setitem__(
        "/".join(path), _norm(R.spec_for_param(path, tuple(leaf.shape),
                                               axes))), params)
    return out


def _jax_param_specs(arch, axes):
    spec = j_get_arch(arch)
    cfg = spec.make_config()
    shapes = jax.eval_shape(lambda: spec.model.init(jax.random.PRNGKey(0),
                                                    cfg))
    mesh = _StubMesh(axes)
    return {JR._names(path): _norm(JR.spec_for_param(path, leaf.shape, mesh))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                shapes)[0]}


@pytest.mark.parametrize("arch", sorted(
    ["qwen3-8b", "gemma-7b", "minitron-8b", "phi3-medium-14b",
     "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b", "qwen2-vl-7b",
     "xlstm-1.3b", "recurrentgemma-9b", "whisper-large-v3"]))
def test_param_specs_match_jax(arch):
    """Every param leaf at full width, both production meshes."""
    assert arch in list_archs()
    for name, axes in MESHES.items():
        got, want = _port_param_specs(arch, axes), _jax_param_specs(arch,
                                                                    axes)
        assert got == want, (arch, name)
        assert any(s for s in got.values()), (arch, name)


_JAX_IO = r"""
import json, sys
import jax
from repro.configs import SHAPES, get_arch, list_archs
from repro.configs.registry import input_specs
from repro.sharding import batch_shardings, state_shardings
from repro.sharding.rules import _names
meshes = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
out = {}
for mname, (shape, names) in meshes.items():
    n = 1
    for s in shape:
        n *= s
    mesh = jax.make_mesh(shape, names, devices=jax.devices()[:n])
    for arch in list_archs():
        spec = get_arch(arch)
        cfg = spec.make_config()
        for sname, sh in SHAPES.items():
            specs = input_specs(spec, cfg, sh)
            if sh.kind == "decode":
                tree = {"tokens": batch_shardings(
                    {"tokens": specs["tokens"]}, mesh)["tokens"],
                    "state": state_shardings(specs["state"], mesh)}
            else:
                tree = batch_shardings(specs, mesh)
            leaves = jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(
                    x, jax.sharding.NamedSharding))[0]
            out[f"{mname}|{arch}|{sname}"] = [
                [_names(p), [list(e) if isinstance(e, tuple) else e
                             for e in s.spec]] for p, s in leaves]
json.dump(out, sys.stdout)
"""


def _env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p])
    return env


def test_batch_and_state_specs_match_jax():
    """``batch_shardings`` / ``state_shardings`` of every architecture x
    shape's inputs on both meshes, against JAX's ``NamedSharding``s."""
    res = subprocess.run(
        [sys.executable, "-c", _JAX_IO], capture_output=True, text=True,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=512"),
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    want = json.loads(res.stdout)
    n = 0
    for mname, axes in MESHES.items():
        for arch in list_archs():
            spec = get_arch(arch)
            cfg = spec.make_config()
            for sname, sh in SHAPES.items():
                specs = input_specs(spec, cfg, sh)
                if sh.kind == "decode":
                    tree = {"tokens": R.batch_shardings(
                        {"tokens": specs["tokens"]}, axes)["tokens"],
                        "state": R.state_shardings(specs["state"], axes)}
                else:
                    tree = R.batch_shardings(specs, axes)
                got = []
                tree_map_with_path(lambda p, s: got.append(
                    ["/".join(p), _norm(s.spec)]), tree)
                exp = [[p, _norm(tuple(tuple(e) if isinstance(e, list)
                                       else e for e in s))]
                       for p, s in want[f"{mname}|{arch}|{sname}"]]
                assert got == exp, (mname, arch, sname)
                n += len(got)
    assert n > 400


_MOE_EP = r"""
import sys
import numpy as np
import jax, torch
from repro.configs import get_arch as jga
from repro.sharding import rules as JR
from repro_torch.configs import get_arch
from repro_torch.sharding import dtensor as D
from repro_torch.sharding import rules as R
from repro_torch.tree import tree_map_with_path

class Stub:
    def __init__(self, axes):
        self.axis_names = tuple(a for a, _ in axes)
        self.devices = np.empty(tuple(n for _, n in axes), object)

for axes in ((("data", 16), ("model", 16)),
             (("pod", 2), ("data", 16), ("model", 16))):
    for arch in ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"):
        js = jga(arch)
        shapes = jax.eval_shape(lambda: js.model.init(
            jax.random.PRNGKey(0), js.make_config()))
        want = {JR._names(p): tuple(JR.spec_for_param(p, l.shape, Stub(axes)))
                for p, l in jax.tree_util.tree_flatten_with_path(shapes)[0]
                if "/moe/w" in JR._names(p)}
        spec = get_arch(arch)
        with torch.device("meta"):
            params = spec.model.init(None, spec.make_config())
        got = {}
        tree_map_with_path(lambda p, l: got.__setitem__(
            "/".join(p), R.spec_for_param(p, tuple(l.shape), axes)), params)
        got = {k: v for k, v in got.items() if k in want}
        assert got == want, (arch, got, want)
        assert any(v[-3] == "data" for v in got.values()), got
print("ok", len(want))
"""


def test_moe_ep_data_branch_matches_jax():
    """With ``REPRO_MOE_EP=data`` the experts' leading dim goes over
    "data" in both packages."""
    res = subprocess.run([sys.executable, "-c", _MOE_EP],
                         capture_output=True, text=True,
                         env=_env(REPRO_MOE_EP="data"), timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("ok")


def test_placements_are_pod_major():
    from torch.distributed.tensor import Replicate, Shard
    axes = MESHES["2x16x16"]
    assert R.placements((("pod", "data"), None, "model"), axes) == (
        Shard(0), Shard(0), Shard(2))
    assert R.placements((), axes) == (Replicate(),) * 3
    assert R.local_shape((64, 8, 32), (("pod", "data"), None, "model"),
                         axes) == (2, 8, 2)
    with pytest.raises(ValueError):
        R.placements(("data", "data"), axes)


def test_constraints_are_identities_without_a_mesh():
    """No ``mesh_axes``, or plain tensors under one: each constraint
    returns its argument itself."""
    x = torch.randn(4, 8, 16)
    s = torch.randn(4, 2, 2, 8, 8)
    cfg = get_arch("qwen3-8b").make_smoke_config()
    axes = MESHES["16x16"]
    for mesh_axes in (None, axes):
        assert C.constrain_dims(x, mesh_axes, ("dp", None, "tp")) is x
        assert A._constrain_scores(s, mesh_axes) is s
        assert M._constrain(x, mesh_axes, (("data",), None, "model")) is x
        assert D.apply_spec(x, axes, ("data",)) is x
    assert C.constrain_act(x, cfg) is x
    assert C.constrain_act(x, cfg, kind="logits") is x
    sharded = type(cfg)(**{**cfg.__dict__, "mesh_axes": axes})
    assert C.constrain_act(x, sharded) is x
    # the specs the constraints would apply
    assert D.dims_spec((32, 8, 64), axes, ("dp", None, "tp")) == (
        ("data",), None, "model")
    assert D.dims_spec((8, 8, 8), axes, ("dp", None, "tp")) == (
        None, None, None)


class _Launch:
    def __init__(self, tmp, cases, timeout, **env):
        self.inputs = W.make_inputs()
        job = dict(world=4, store=str(tmp / "store"), out=str(tmp),
                   mesh=(2, 2), cases=cases, inputs=self.inputs)
        with open(tmp / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        self.tmp, self.deadline = tmp, time.monotonic() + timeout
        self.logs = [open(tmp / f"rank{r}.log", "w") for r in range(4)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests",
                                          "_torch_shard_worker.py"),
             str(tmp / "job.pkl"), str(r)], env=_env(**env),
            stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(4)]

    def results(self):
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pytest.fail("4-rank launch did not finish in time")
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


F32 = {"compute_dtype": "float32"}
CASES = [dict(arch=a, kind=k, overrides=o) for a, o in [
    ("qwen3-8b", F32),
    ("llama4-scout-17b-a16e", dict(F32, capacity_factor=4.0)),
    ("xlstm-1.3b", F32),
    ("recurrentgemma-9b", F32),
    ("whisper-large-v3", F32)] for k in ("prefill", "decode", "train")]
CASES += [dict(arch="qwen3-8b", kind="prefill",
               overrides=dict(F32, attention_impl="kernel")),
          dict(arch="xlstm-1.3b", kind="prefill",
               overrides=dict(F32, slstm_impl="kernel"))]


def _case_id(c):
    return "-".join([c["arch"], c["kind"]] + sorted(
        f"{k}" for k in c["overrides"] if k.endswith("impl")))


@pytest.fixture(scope="module")
def shard_runs(tmp_path_factory):
    """Every case on four ranks while the single-device port computes the
    same cases here."""
    launch = _Launch(tmp_path_factory.mktemp("shard"), CASES, timeout=400)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        refs = [W.run_case(c, launch.inputs) for c in CASES]
    finally:
        torch.set_num_threads(n)
    return launch.results(), refs


@pytest.mark.parametrize("index", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_sharded_lm_matches_single_device(shard_runs, index):
    ranks, refs = shard_runs
    want = refs[index]
    for rank, res in enumerate(ranks):
        r = res[index]
        assert "ok" in r, f"rank {rank}:\n{r.get('error')}"
        got = r["ok"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


EP_CASES = [dict(arch="llama4-scout-17b-a16e", kind=k,
                 overrides=dict(F32, capacity_factor=4.0))
            for k in ("prefill", "train")]


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_moe_ep_data_layout_matches_single_device(tmp_path, kind):
    """Under ``REPRO_MOE_EP=data`` (read at import in the ranks) the
    experts' weights lie over "data" and their products take the
    all-to-all layout; llama4-scout's prefill and SGD step on the 2x2
    mesh still equal the single-device port's."""
    case = next(c for c in EP_CASES if c["kind"] == kind)
    launch = _Launch(tmp_path, [case], timeout=300, REPRO_MOE_EP="data")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = W.run_case(case, launch.inputs)
    finally:
        torch.set_num_threads(n)
    for rank, res in enumerate(launch.results()):
        assert "ok" in res[0], f"rank {rank}:\n{res[0].get('error')}"
        got = res[0]["ok"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_a_dtensor_on_another_mesh_raises():
    """The constraints read the DTensor's own mesh, which must be the
    config's ``mesh_axes``; on it they redistribute to the spec."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.dryrun import fake_world
    with fake_world(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.empty(4, 8, 16, device="meta"), mesh,
                              [Replicate(), Replicate()])
        y = C.constrain_dims(x, (("data", 2), ("model", 2)),
                             ("dp", None, "tp"))
        assert tuple(y.placements) == (Shard(0), Shard(2))
        with pytest.raises(ValueError, match="mesh"):
            C.constrain_dims(x, (("data", 4), ("model", 1)),
                             ("dp", None, "tp"))
        s = distribute_tensor(torch.empty(4, 2, 2, 8, 8, device="meta"),
                              mesh, [Replicate(), Replicate()])
        assert tuple(A._constrain_scores(
            s, (("data", 2), ("model", 2))).placements) == (Shard(0),
                                                            Shard(3))
        with pytest.raises(ValueError, match="mesh"):
            A._constrain_scores(s, (("pod", 2), ("model", 2)))
