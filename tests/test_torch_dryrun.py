"""The port's dry run (``repro_torch.launch.dryrun``) and its collective
accounting (``repro_torch.roofline.collectives``), on ``cpu`` meshes over
a ``fake`` process group that each call starts and tears down.

* ``lower_one`` returns every key of the JAX package's result, and its
  ``argument_bytes`` is the sum of the local shards the rules imply.
* On a 1x1 mesh its FLOPs equal ``FlopCounterMode`` on the plain step,
  for prefill, decode and a train step of each family.
* Per-device FLOPs: the tracer counts each op on the local shards; a
  mode above DTensor would count the global op (the test shows both).
* On a 16x16 mesh a train step records all-gathers and reduce-scatters.
* A train step's ``alias_bytes`` are its new params and AdamW moments
  (what a donating runtime writes over the arguments), and its
  ``temp_bytes`` hold them (the eager step donates nothing).
* ``collective_bytes`` applies the JAX package's traffic factors.
* The command line prints a ``summarize`` row.
"""
import dataclasses
import math
import os
import re
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_arch
from repro_torch.configs.registry import input_specs
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun as DR
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.optim import adamw, sgd_momentum
from repro_torch.roofline.collectives import _COLL_FACTOR, collective_bytes
from repro_torch.sharding import rules as R
from repro_torch.tree import tree_leaves
from test_torch_lm_train import _one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["qwen3-8b", "llama4-scout-17b-a16e", "xlstm-1.3b",
            "recurrentgemma-9b", "whisper-large-v3"]


@pytest.fixture(autouse=True, scope="module")
def _no_group():
    """The dry run starts its own fake group: none may be up."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    assert not dist.is_initialized()


def smoke(arch):
    """The smoke config's fields, as overrides of the full config."""
    return dataclasses.asdict(get_arch(arch).make_smoke_config())


def _jax_result_keys():
    """The keys of the JAX package's ``lower_one`` result, read from its
    source (importing it would set its XLA flags)."""
    src = open(os.path.join(ROOT, "src", "repro", "launch",
                            "dryrun.py")).read()
    body = src[src.index("    result = {"):src.index("    if keep_text:")]
    return set(re.findall(r'"([a-z_]+)":', body))


def test_lower_one_keys_and_argument_bytes():
    shape = InputShape("t", 64, 32, "train")
    res = DR.lower_one("qwen3-8b", shape, cfg_overrides=smoke("qwen3-8b"),
                       device="cpu")
    keys = set(res) | set(res["memory"]) | set(res["cost"])
    assert _jax_result_keys() <= keys
    assert res["devices"] == 256 and res["mesh"] == "16x16"
    assert res["compile_s"] == 0.0
    # the local shards of params, momentum (f32) and batch
    spec = get_arch("qwen3-8b")
    axes = (("data", 16), ("model", 16))
    cfg = spec.make_config(**dict(smoke("qwen3-8b"), mesh_axes=axes))
    with torch.device("meta"):
        params = spec.model.init(None, cfg)
    want = 0
    for t, s in zip(tree_leaves(params),
                    tree_leaves(R.param_shardings(params, axes))):
        n = math.prod(R.local_shape(t.shape, s.spec, axes))
        want += n * (t.element_size() + 4)
    batch = input_specs(spec, cfg, shape)
    for t, s in zip(tree_leaves(batch),
                    tree_leaves(R.batch_shardings(batch, axes))):
        want += math.prod(R.local_shape(t.shape, s.spec, axes)) \
            * t.element_size()
    assert res["memory"]["argument_bytes"] == want
    m = res["memory"]
    assert m["alias_bytes"] > 0 and m["temp_bytes"] > m["alias_bytes"]
    assert res["cost"]["flops"] > 0 and res["cost"]["bytes_accessed"] > 0


def _plain_flops(arch, shape):
    spec = get_arch(arch)
    cfg = spec.make_config(**smoke(arch))
    with torch.device("meta"):
        params = spec.model.init(None, cfg)
    specs = input_specs(spec, cfg, shape)
    with FlopCounterMode(display=False) as f:
        if shape.kind == "prefill":
            make_prefill_step(spec, cfg)(params, specs)
        elif shape.kind == "train":
            opt = sgd_momentum(1e-2, momentum=0.9,
                               state_dtype=torch.float32)
            make_train_step(spec, cfg, opt)(params, opt.init(params), 0,
                                            specs)
        else:
            make_decode_step(spec, cfg)(params, specs["state"],
                                        specs["tokens"], 0)
    return f.get_total_flops()


@pytest.mark.parametrize("arch", FAMILIES)
def test_one_by_one_flops_equal_flop_counter(arch):
    """Same graph, same count: the 1x1 DTensor step's local ops against
    ``FlopCounterMode`` on the plain step."""
    for kind in ("prefill", "decode", "train"):
        shape = InputShape("s", 16, 4, kind)
        res = DR.lower_one(arch, shape, cfg_overrides=smoke(arch),
                           mesh_shape=(1, 1), device="cpu")
        assert res["devices"] == 1
        assert res["cost"]["flops"] == _plain_flops(arch, shape) > 0, kind


def test_flops_are_counted_on_the_local_shards():
    """A (256 x 4096) @ (4096 x 4096) product sharded over 16 x 16: the
    tracer counts 1/256 of the global product on each device, where
    ``FlopCounterMode`` above DTensor counts the global op."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with DR.fake_world(256):
        mesh = init_device_mesh("cpu", (16, 16),
                                mesh_dim_names=("data", "model"))
        x = distribute_tensor(torch.empty(256, 4096, device="meta"), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(4096, 4096, device="meta"), mesh,
                              [Replicate(), Shard(1)])
        tracer = DR.StepTracer()
        with tracer:
            y = x @ w
        with FlopCounterMode(display=False) as f:
            x @ w
    glob = 2 * 256 * 4096 * 4096
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert f.get_total_flops() == glob
    assert tracer.flops == glob // 256
    assert tracer.records == []            # nothing moved


def test_train_step_records_gathers_and_reduce_scatters():
    res = DR.lower_one("qwen3-8b", InputShape("t", 64, 32, "train"),
                       cfg_overrides=smoke("qwen3-8b"), device="cpu")
    coll = res["collectives"]
    for op in ("all-gather", "reduce-scatter"):
        assert coll[op]["count"] > 0 and coll[op]["bytes"] > 0
    for op, d in coll.items():
        assert d["traffic_bytes"] == int(d["bytes"] * _COLL_FACTOR[op])


def test_train_alias_is_the_donated_state():
    """On a 1x1 mesh with AdamW (``chip_smoke.py`` phase 28b's step): the
    aliased bytes are the new params and both moments, three times the
    f32 params; a prefill aliases nothing."""
    over = dict(smoke("qwen3-8b"), compute_dtype="float32")
    res = DR.lower_one("qwen3-8b", InputShape("t", 16, 2, "train"),
                       cfg_overrides=over, optimizer=adamw(1e-3),
                       mesh_shape=(1, 1), device="cpu")
    spec = get_arch("qwen3-8b")
    with torch.device("meta"):
        params = spec.model.init(None, spec.make_config(**over))
    p_bytes = sum(t.nbytes for t in tree_leaves(params))
    batch = sum(t.nbytes for t in tree_leaves(input_specs(
        spec, spec.make_config(**over), InputShape("t", 16, 2, "train"))))
    m = res["memory"]
    assert m["argument_bytes"] == 3 * p_bytes + batch
    assert m["alias_bytes"] == 3 * p_bytes
    assert m["temp_bytes"] > m["alias_bytes"]
    assert m["output_bytes"] == 3 * p_bytes + 4          # and the loss
    pre = DR.lower_one("qwen3-8b", InputShape("p", 16, 2, "prefill"),
                       cfg_overrides=over, mesh_shape=(1, 1), device="cpu")
    assert pre["memory"]["alias_bytes"] == 0


def test_collective_bytes_applies_jax_factors():
    """The same collectives as HLO text through the JAX package's parser
    and as records through the port's."""
    from repro.roofline.hlo import collective_bytes_from_text
    ops = [("all-gather", "f32", (4, 512, 1024)),
           ("all-reduce", "bf16", (8, 256)),
           ("all-reduce", "f32", (16,)),
           ("reduce-scatter", "f32", (2, 64)),
           ("all-to-all", "bf16", (32, 32)),
           ("collective-permute", "s32", (7,))]
    size = {"f32": 4, "bf16": 2, "s32": 4}
    text = "\n".join(
        f"  %x.{i} = {dt}[{','.join(map(str, sh))}]{{0}} {op}(%p)"
        for i, (op, dt, sh) in enumerate(ops))
    records = [(op, math.prod(sh) * size[dt]) for op, dt, sh in ops]
    assert collective_bytes(records) == collective_bytes_from_text(text)
    assert collective_bytes([]) == {}


def test_cli_prints_a_summary_row(tmp_path):
    """``python -m repro_torch.launch.dryrun`` at full size, on the CPU:
    one ``summarize`` row and the JSON result (qwen3-8b ``decode_32k``
    traces in seconds; ``train_4k`` is ``chip_smoke.py``'s and the
    README's)."""
    out_json = tmp_path / "r.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-8b", "--shape", "decode_32k", "--device", "cpu", "--out",
         str(out_json)], capture_output=True, text=True, env=env,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    row = out.stdout.strip().splitlines()[-1]
    assert row.startswith("qwen3-8b") and "decode_32k" in row
    assert "16x16" in row and "GiB/dev" in row and "compile=0.0s" in row
    import json
    res = json.loads(out_json.read_text())[0]
    assert res["devices"] == 256 and res["cost"]["flops"] > 0
