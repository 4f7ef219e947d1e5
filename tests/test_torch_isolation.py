"""The port stands alone: importing every module of ``repro_torch``,
running a one-step SFPL epoch, single-device and sharded (world size 1,
int8 wire), a qwen3-8b smoke prefill through the kernel attention path, an
xlstm-1.3b smoke prefill through the sLSTM kernel path, smoke prefills of
llama4-scout, llama4-maverick and qwen2-vl (vision embeddings included)
through the kernel attention path, recurrentgemma-9b and whisper-large-v3
(frame embeddings included) through the kernel attention path, a 3-token
``serve`` of each, a fault
plan's draw, a train-state checkpoint round trip, ``retry_call``, ``multihost.host_value``, one SFPL LM train
step and a dry run on the 16x16 fake mesh (``launch/dryrun.py``, the
sharding rules, the roofline's collectives) loads neither ``jax`` nor
``repro``; and the entry points run on CUDA
by default, raising when it is absent."""
import os
import subprocess
import sys

import pytest
import torch

SCRIPT = r"""
import importlib, pkgutil, sys
import torch
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)

from repro_torch.core import engine as E
from repro_torch.data import make_synthetic_cifar, partition_positive_labels
from repro_torch.models import resnet as R
from repro_torch.optim import sgd_momentum

n, b = 2, 2
cfg = R.ResNetConfig(depth=8, num_classes=n, width=4)
g = torch.Generator().manual_seed(0)
tx, ty, _, _ = make_synthetic_cifar(g, num_classes=n, train_per_class=b,
                                    test_per_class=1, hw=8)
data = partition_positive_labels(tx, ty, n)
opt = sgd_momentum(0.05, momentum=0.9)
st = E.init_dcml_state(g, lambda k: R.init(k, cfg), n, opt, opt)
st, losses = E.sfpl_epoch(g, st, data, E.make_resnet_split(cfg), opt, opt,
                          num_clients=n, batch_size=b, device="cpu")
assert losses.shape == (1,) and bool(torch.isfinite(losses).all())

from repro_torch.core import engine_dist as ED
grp = ED.init_data_group("cpu")
st, losses = ED.sfpl_epoch_sharded(
    g, st, data, E.make_resnet_split(cfg), opt, opt, group=grp,
    num_clients=n, batch_size=b, wire_dtype="int8", device="cpu")
ED.close_data_group()
assert losses.shape == (1,) and bool(torch.isfinite(losses).all())

import dataclasses
from repro_torch.configs import get_arch
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_prefill_step
spec = get_arch("qwen3-8b")
lm_cfg = dataclasses.replace(spec.make_smoke_config(), attention_impl="kernel")
lm_params = spec.model.init(torch.Generator().manual_seed(0), lm_cfg)
toks = torch.randint(0, lm_cfg.vocab_size, (2, 8))
logits = make_prefill_step(spec, lm_cfg)(lm_params, {"tokens": toks})
assert logits.shape == (2, 1, lm_cfg.vocab_size)
assert bool(torch.isfinite(logits).all())
out = serve("qwen3-8b", batch=2, prompt_len=4, gen=3, device="cpu")
assert out.shape == (2, 3)

x_spec = get_arch("xlstm-1.3b")
x_cfg = x_spec.make_smoke_config(slstm_impl="kernel")
x_params = x_spec.model.init(torch.Generator().manual_seed(0), x_cfg)
x_toks = torch.randint(0, x_cfg.vocab_size, (2, 8))
x_logits = make_prefill_step(x_spec, x_cfg)(x_params, {"tokens": x_toks})
assert x_logits.shape == (2, 1, x_cfg.vocab_size)
assert bool(torch.isfinite(x_logits).all())
out = serve("xlstm-1.3b", batch=2, prompt_len=4, gen=3, device="cpu")
assert out.shape == (2, 3)

for arch in ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
             "qwen2-vl-7b"):
    m_spec = get_arch(arch)
    m_cfg = dataclasses.replace(m_spec.make_smoke_config(),
                                attention_impl="kernel")
    m_params = m_spec.model.init(torch.Generator().manual_seed(0), m_cfg)
    m_batch = {"tokens": torch.randint(0, m_cfg.vocab_size, (2, 20))}
    if m_cfg.vision_tokens:
        m_batch["vision_embeds"] = torch.randn(2, m_cfg.vision_tokens,
                                               m_cfg.d_model)
    m_logits = make_prefill_step(m_spec, m_cfg)(m_params, m_batch)
    assert bool(torch.isfinite(m_logits).all())
    out = serve(arch, batch=2, prompt_len=4, gen=3, device="cpu")
    assert out.shape == (2, 3)

for arch in ("recurrentgemma-9b", "whisper-large-v3"):
    r_spec = get_arch(arch)
    r_cfg = r_spec.make_smoke_config(attention_impl="kernel")
    r_params = r_spec.model.init(torch.Generator().manual_seed(0), r_cfg)
    r_batch = {"tokens": torch.randint(0, r_cfg.vocab_size, (2, 20))}
    if r_spec.family == "whisper":
        r_batch["frame_embeds"] = torch.randn(2, 16, r_cfg.d_model)
    r_logits = make_prefill_step(r_spec, r_cfg)(r_params, r_batch)
    assert r_logits.shape == (2, 1, r_cfg.vocab_size)
    assert bool(torch.isfinite(r_logits).all())
    out = serve(arch, batch=2, prompt_len=4, gen=3, device="cpu")
    assert out.shape == (2, 3)

import os, tempfile
from repro_torch import checkpoint as CK
from repro_torch.core.faults import FaultPlan, ensure_group_survivor
from repro_torch.core.retry import retry_call
from repro_torch.core.split_lm import make_collector_perm
from repro_torch.data.tokens import synthetic_token_stream
from repro_torch.launch import multihost
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import adamw
mask, _ = FaultPlan(n, seed=1, drop_rate=0.5).participation(0)
mask, _ = ensure_group_survivor(mask, n)
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "st.npz")
    CK.save_train_state(path, st, gen=g, epoch=1)
    st2, _, ep = CK.restore_train_state(path, st)
    assert ep == 1
assert multihost.host_value(losses).shape == (1,)
assert retry_call(lambda: 3, attempts=1) == 3
opt = adamw(1e-3)
step = make_train_step(spec, spec.make_smoke_config(), opt, sfpl=True)
toks, labels = synthetic_token_stream(g, batch=2, seq_len=8, vocab=512)
lm_params = spec.model.init(g, spec.make_smoke_config())
lm_params, _, _, loss = step(lm_params, opt.init(lm_params), 0,
                             {"tokens": toks, "labels": labels,
                              "perm": make_collector_perm(g, 2)})
assert bool(torch.isfinite(loss))

from repro_torch.configs.shapes import InputShape
from repro_torch.launch.dryrun import lower_one, summarize
smoke = dataclasses.asdict(spec.make_smoke_config())
res = lower_one("qwen3-8b", InputShape("t", 16, 32, "train"),
                cfg_overrides=smoke, device="cpu")
assert res["cost"]["flops"] > 0 and "GiB/dev" in summarize(res)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("MODULES", len(names))
print("LEAKED", leaked)
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.path.abspath("src"))
    res = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LEAKED []" in res.stdout, res.stdout
    n_modules = int(res.stdout.split("MODULES ")[1].split()[0])
    assert n_modules >= 30, res.stdout


def test_entry_points_default_to_cuda_and_raise_without_it():
    from repro_torch.core import engine as E
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import serve
    from repro_torch.launch.train import train_paper
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    for call in (lambda: resolve_device(None),
                 lambda: train_paper(epochs=1),
                 lambda: serve("qwen3-8b", gen=1),
                 lambda: serve("xlstm-1.3b", gen=1),
                 lambda: serve("recurrentgemma-9b", gen=1),
                 lambda: serve("whisper-large-v3", gen=1),
                 lambda: E.sfpl_epoch(None, {}, {}, None, None, None,
                                      num_clients=1, batch_size=1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_later_slice_knobs_raise_not_implemented():
    """The fault knobs, checkpoints and LM mode are ported; what still
    raises: an architecture the port does not register (all ten of the
    JAX package's are; an unknown id raises the registry's ``KeyError``),
    and fault rates on the SFLv2 scheme (the JAX launcher's
    ``ValueError``)."""
    from repro_torch.launch.train import main
    with pytest.raises(KeyError, match="unknown arch"):
        main(["--arch", "no-such-arch", "--device", "cpu",
              "--steps", "1"])
    with pytest.raises(ValueError, match="requires --scheme sfpl"):
        main(["--paper", "--scheme", "sflv2", "--drop-rate", "0.2",
              "--device", "cpu", "--epochs", "1"])


@pytest.mark.parametrize("argv", [
    ["--pods", "2"], ["--pipeline", "double_buffered"], ["--submesh"],
    ["--sharded", "--scheme", "sflv2"]])
def test_slice_c2_knobs_raise_naming_c2(argv):
    """The sharded knobs that raised ``NotImplementedError`` naming slice
    C2 are ported: at world size 1 the double-buffered pipeline and
    sharded SFLv2 train, while ``--pods 2`` (no divisor of one rank) and
    ``--submesh`` on the sync pipeline raise the layout's ``ValueError``,
    as the JAX package's launcher does, before any device work."""
    from repro_torch.launch.train import main
    run = lambda: main(["--paper", "--sharded", "--device", "cpu",
                        "--epochs", "1", "--clients", "4"] + argv)
    if argv[0] in ("--pods", "--submesh"):
        with pytest.raises(ValueError, match="pods=2|double_buffered"):
            run()
    else:
        run()
    # the launcher leaves no process group behind, raising or not
    assert not torch.distributed.is_initialized()


def test_c2_layouts_raise_in_the_engine():
    """The C2 layouts pass the engine's checks as the JAX package's do;
    a layout that does not qualify raises ``ValueError`` before any
    collective, with no process group."""
    from repro.core import engine_dist as JED
    from repro_torch.core import engine_dist as ED
    from repro_torch.core.round import DataGroup
    for kw in ({"collector_pipeline": "double_buffered"},
               {"collector_submesh": True}, {"pods": 2},
               {"collector_pipeline": "double_buffered", "alpha": 0.5,
                "pods": 2, "collector_submesh": True}):
        assert ED.check_sfpl_layout(8, 8, 2, **kw) == \
            JED.check_sfpl_layout(8, 8, 2, **kw)
    for kw in ({"pods": 3}, {"collector_pipeline": "double_buffered",
                             "alpha": 0.25, "collector_submesh": True}):
        with pytest.raises(ValueError):
            ED.check_sfpl_layout(8, 8, 2, **kw)
    with pytest.raises(ValueError, match="collector_submesh=True"):
        ED.sfpl_epoch_sharded(None, {}, {}, None, None, None,
                              group=DataGroup(None, 0, 2), num_clients=8,
                              batch_size=8, alpha=0.25,
                              collector_pipeline="double_buffered",
                              collector_submesh=True)
