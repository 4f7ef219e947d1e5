"""CPU tests of the benchmark harness in ``bench/``.

They check the contract's shape of ``BENCHMARK.json``, that a new
configuration, traffic mix, cell or per-layer metric is found from its
files alone, the yardstick's FLOP counts against hand counts, the trace
reading on a CPU profile, the import check, a tiny run of a cell on
the CPU in which the port and the plain reference agree, and a second
model family (a split MLP) added as files only, whose program module is
found by its ``model.arch``, run, calibrated and caught when broken.
"""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from bench import calibrate, compare, run, spec, tracing, yardstick

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY_CONFIG = {"depth": 8, "num_classes": 4, "image_hw": 8}
TINY_DEPLOYMENT = {"clients": 4, "samples_per_client": 32}


def tiny_tree(tmp_path, limits_from="r56_c100.train_b128"):
    """A copy of the benchmark's files with one more configuration,
    traffic mix, cell and per-layer metric, each added as files and
    entries only. The cell is ``tiny.cpu``: ResNet-8 on 8 x 8 images, 4
    clients of 32, batch 8, held to ``limits_from``'s limits."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "bench"
    cfg = json.loads((b / "configs" / "sfpl-resnet56-cifar100.json")
                     .read_text())
    cfg["name"] = "tiny"
    cfg["model"].update(TINY_CONFIG)
    cfg["deployment"].update(TINY_DEPLOYMENT)
    (b / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (b / "traffic" / "tiny_b8.json").write_text(json.dumps(
        {"client_batch": 8, "check_epochs": [1, 2], "trace_epochs": 1}))
    limits = json.loads((b / "workloads" / f"{limits_from}.json")
                        .read_text())["limits"]
    (b / "workloads" / "tiny.cpu.json").write_text(json.dumps(
        {"limits": limits}))
    (b / "metrics" / "train.kernel_count.py").write_text(
        "def read(trace):\n    return len(trace.kernels) or None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "bench/configs/tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.cpu", "config": "tiny",
                               "traffic": "tiny_b8", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("tiny.cpu")
    bench["per_layer"].append({"name": "train.kernel_count",
                               "unit": "kernels", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "train_samples_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


# --------------------------------------------------------------------------
# BENCHMARK.json and its files

def test_benchmark_json_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    named = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for entry in named:
        assert NAME.match(entry["name"]), entry["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    names = [e["name"] for e in named]
    assert len(names) == len(set(names))
    assert "setup_s" in e2e
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_reports_what_its_layer_metrics_move():
    """Each cell reports setup_s, another end-to-end metric and a per-layer
    metric, and every per-layer metric it reports moves an end-to-end
    metric that it reports."""
    for w in BENCH["workloads"]:
        cell = spec.Cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer()
        for m in cell.per_layer():
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_name_has_its_files():
    for w in BENCH["workloads"]:
        cell = spec.Cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) >= {"loss_gap", "head_grad_err",
                                    "nonfinite"}
        for m in cell.per_layer():
            assert callable(cell.reader(m["name"]))
    for c in BENCH["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        assert (ROOT / c["file"]).is_file()


def test_new_files_are_found_without_editing_others(tmp_path):
    root = tiny_tree(tmp_path)
    cell = spec.Cell("tiny.cpu", root)
    assert cell.config["model"]["depth"] == 8
    assert cell.traffic["client_batch"] == 8
    assert "train.kernel_count" in [m["name"] for m in cell.per_layer()]
    fake = type("T", (), {"kernels": [1, 2, 3]})()
    assert cell.reader("train.kernel_count")(fake) == 3
    with pytest.raises(KeyError):
        spec.Cell("tiny.cpu")               # not in the repo's own file


# --------------------------------------------------------------------------
# the yardstick

def _hand_macs(depth, classes, w=16, hw=32):
    n = (depth - 2) // 6
    stem = 3 * 3 * 3 * w * hw * hw
    s0 = n * 2 * (9 * w * w * hw * hw)
    s1 = (9 * w * 2 * w + w * 2 * w) * (hw // 2) ** 2 \
        + (2 * n - 1) * 9 * (2 * w) ** 2 * (hw // 2) ** 2
    s2 = (9 * 2 * w * 4 * w + 2 * w * 4 * w) * (hw // 4) ** 2 \
        + (2 * n - 1) * 9 * (4 * w) ** 2 * (hw // 4) ** 2
    return stem, s0 + s1 + s2 + 4 * w * classes


@pytest.mark.parametrize("depth,classes,mflop",
                         [(56, 100, 753.636864), (32, 10, 413.86368)])
def test_model_flops_match_hand_count(depth, classes, mflop):
    cfg = {"depth": depth, "width": 16, "num_classes": classes,
           "in_channels": 3, "image_hw": 32}
    stem, rest = _hand_macs(depth, classes)
    hand = 2 * stem * 2 + 2 * rest * 3
    assert yardstick.model_flops_per_sample(cfg) == hand
    assert hand / 1e6 == pytest.approx(mflop)


def test_kernel_bytes_count_each_launch():
    cfg = json.loads((ROOT / "bench/configs/sfpl-resnet56-cifar100.json")
                     .read_text())["model"]
    k = yardstick.kernel_step_bytes(cfg, 5000, 100)
    assert k["collector_permute"] == (2, 2 * (2 * 5000 * 32 * 32 * 16 * 2
                                           + 5000 * 8))
    assert k["bn_act"][0] == 58          # 56 server BNs, the clients' twice
    assert k["xent_bwd"] == (1, 2 * 5000 * 100 * 2 + 5000 * 16)


def test_conv_rows_from_a_cpu_profile(tmp_path):
    """The recorded shapes of a forward and a backward give the least
    time by hand: the stem-like conv (input needs no grad) has no
    data-grad."""
    from torch.profiler import ProfilerActivity, profile, record_function
    x = torch.randn(4, 6, 8, 8)
    w = torch.randn(8, 3, 3, 3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        with record_function(tracing.WINDOW):
            y = torch.nn.functional.conv2d(x, w, padding=1, groups=2)
            y.sum().backward()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    convs = [e for e in events if e.get("name") in tracing.CONV_OPS]
    fake = []
    for i, e in enumerate(convs):
        fake.append({"ph": "X", "cat": "cuda_runtime",
                     "name": "cudaLaunchKernel", "tid": e["tid"],
                     "pid": e["pid"], "ts": e["ts"] + e["dur"] / 2,
                     "dur": 0.01, "args": {"correlation": 10 ** 6 + i}})
        fake.append({"ph": "X", "cat": "kernel", "name": "conv_kernel",
                     "tid": 7, "pid": 0, "ts": e["ts"] + e["dur"] / 2,
                     "dur": 1.0, "args": {"correlation": 10 ** 6 + i}})
    cell = spec.Cell("r56_c100.train_b128")
    tr = tracing.Trace(events + fake, cell=cell, steps=1, samples=4)
    calls = tr.conv_calls()
    assert [c[0] for c in calls] == ["aten::convolution",
                                     "aten::convolution_backward"]
    peak = 1e12
    fwd = 2 * 4 * 8 * 8 * 8 * 3 * 9
    nbytes = 4 * (4 * 6 * 64 + 8 * 27 + 4 * 8 * 64)
    assert tracing.conv_least_seconds(calls[0], lambda t: peak) == \
        pytest.approx(max(fwd / peak, nbytes / yardstick.HBM_BYTES_PER_S))
    assert tracing.conv_least_seconds(calls[1], lambda t: peak) == \
        pytest.approx(max(fwd / peak, nbytes / yardstick.HBM_BYTES_PER_S))
    assert tr.summary()["kernels"] == 2
    assert 0 < tr.busy_s <= tr.window_s


def test_kernel_roofline_reader_needs_the_yardstick_counts():
    cell = spec.Cell("r32_c10.train_b128")
    pool = 10 * cell.traffic["client_batch"]
    want = yardstick.kernel_step_bytes(cell.config["model"], pool, 10)
    events = [{"ph": "X", "cat": "user_annotation", "name": tracing.WINDOW,
               "tid": 1, "pid": 1, "ts": 0.0, "dur": 1e6}]
    t = 10.0
    for fam, (n, _) in want.items():
        for _ in range(n):
            events.append({"ph": "X", "cat": "kernel", "tid": 7, "pid": 0,
                           "name": f"void {yardstick.KERNEL_SYMBOLS[fam]}<x>",
                           "ts": t, "dur": 100.0, "args": {}})
            t += 200.0
    tr = tracing.Trace(events, cell=cell, steps=1, samples=pool)
    read = cell.reader("train.kernels_roofline_pct")
    bound = sum(b for _, b in want.values()) / yardstick.HBM_BYTES_PER_S
    device = 1e-4 * sum(n for n, _ in want.values())
    assert read(tr) == pytest.approx(100 * bound / device)
    tr.steps = 2                         # the counts no longer match
    assert read(tr) is None


def test_idle_and_mfu_read_the_device_pass():
    """The device pass's window runs from the first API call to the end of
    the last call or device operation; idle and MFU read it alone, and
    leave themselves out without it."""
    cell = spec.Cell("r32_c10.train_b128")
    events = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
               "ts": 100.0, "dur": 5.0},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 110.0,
               "dur": 300.0},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 300.0,
               "dur": 100.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 600.0,
               "dur": 200.0},
              {"ph": "X", "cat": "cuda_runtime",
               "name": "cudaDeviceSynchronize", "ts": 150.0, "dur": 750.0}]
    busy = tracing.Busy(events, samples=1280)
    assert busy.window_s == pytest.approx(800e-6)
    assert busy.busy_s == pytest.approx(500e-6)
    tr = tracing.Trace([{"ph": "X", "cat": "user_annotation", "tid": 1,
                         "pid": 1, "name": tracing.WINDOW, "ts": 0.0,
                         "dur": 1e3}], cell=cell, steps=1, samples=1280,
                       busy=busy)
    assert cell.reader("train.idle_pct")(tr) == pytest.approx(100 * 3 / 8)
    flops = 1280 * yardstick.model_flops_per_sample(cell.config["model"])
    assert cell.reader("train.mfu_pct")(tr) == pytest.approx(
        100 * flops / (500e-6 * yardstick.PEAK_FLOPS["bfloat16"]))
    tr.busy = None
    assert cell.reader("train.idle_pct")(tr) is None
    assert cell.reader("train.mfu_pct")(tr) is None


# --------------------------------------------------------------------------
# the comparison and the import check

def test_judge_fails_nan_and_over_limit():
    ok, checks = compare.judge({"a": 0.1, "b": 0.0}, {"a": 0.2, "b": 0})
    assert ok and checks["a"] == {"value": 0.1, "limit": 0.2}
    assert not compare.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not compare.judge({"a": 0.3}, {"a": 0.2})[0]


@pytest.mark.parametrize("names,bad", [
    (["repro_torch", "repro_torch.core.round", "reproducible", "jaxtyping",
      "flaxen", "torch"], []),
    (["repro", "repro.core"], ["repro"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"],
     ["flax", "jax", "jaxlib"]),
])
def test_forbidden_modules_compare_whole_top_level_names(names, bad):
    assert run.forbidden_modules(names) == bad


def test_tiny_cell_on_the_cpu_agrees_with_the_reference(tmp_path):
    root = tiny_tree(tmp_path)
    result, checks = run.execute("tiny.cpu", 2 ** 31 + 977, 0.2, 0,
                                 device="cpu", root=root)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] >= 3 + 4
    assert list(checks) == list(json.loads(
        (root / "bench/workloads/tiny.cpu.json").read_text())["limits"])
    assert result["metrics"]["train_samples_per_s"]["value"] > 0


def test_a_cpu_run_loads_no_jax(tmp_path):
    """The harness and the port, driven through a whole tiny run, load
    neither JAX nor the JAX package."""
    root = tiny_tree(tmp_path)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); "
            "from bench import run; "
            f"run.execute('tiny.cpu', 5, 0.1, 0, device='cpu', "
            f"root={str(root)!r}); "
            "print(run.forbidden_modules(sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("with_program", [True, False])
def test_run_prints_no_result_without_a_card_or_a_program(tmp_path,
                                                          with_program):
    """Here (no card), and in a directory that holds only BENCHMARK.json
    and ``bench/``, the command exits non-zero with nothing on stdout."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if with_program:
        (tmp_path / "src").symlink_to(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "r56_c100.train_b128",
         "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


# --------------------------------------------------------------------------
# a model family is its program module, found by model.arch

MLP_PROGRAM = '''"""A two-part MLP trained the SFPL way: each client's layer on its own
rows, the pooled cut activations shuffled, the server's layer on the
shuffled pool, FedAvg of the client layers after every epoch."""
import torch
import torch.nn.functional as F

from bench import run

FAULTS = {"control": {"dtype": torch.bfloat16}, "frozen": {"frozen": True}}
BACK = {back!r}


def make(cell, seed, dev):
    m, d = cell.config["model"], cell.config["deployment"]
    gen = torch.Generator(dev).manual_seed(run.sub_seed(seed, 0))
    centers = torch.randn(d["clients"], m["in_dim"], generator=gen,
                          device=dev)
    x = centers[:, None] + 0.5 * torch.randn(
        d["clients"], d["samples_per_client"], m["in_dim"], generator=gen,
        device=dev)
    y = torch.arange(d["clients"], device=dev)[:, None].expand(
        -1, d["samples_per_client"])
    gen = torch.Generator(dev).manual_seed(run.sub_seed(seed, 1))
    w1 = torch.randn(m["in_dim"], m["hidden"], generator=gen, device=dev)
    w2 = torch.randn(m["hidden"], m["num_classes"], generator=gen,
                     device=dev)
    p = {"client.w": (w1 / m["in_dim"] ** 0.5).expand(
        d["clients"], -1, -1).clone(), "server.w": w2 / m["hidden"] ** 0.5}
    return x, y, p, torch.Generator().manual_seed(run.sub_seed(seed, 2))


def fedavg(p):
    w = p["client.w"]
    return {**p, "client.w": w.mean(0, keepdim=True).expand_as(w).clone()}


class Shuffle(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, perm):
        ctx.save_for_backward(perm)
        return a[perm]

    @staticmethod
    def backward(ctx, g):
        perm, = ctx.saved_tensors
        if BACK == "inverse":
            return torch.empty_like(g).index_copy_(0, perm, g), None
        return g[perm], None


class Runner:
    def __init__(self, cell, seed, dev):
        self.x, self.y, self.p, self.perm_gen = make(cell, seed, dev)
        self.lr = cell.config["optimizer"]["lr"]
        self.batch = cell.traffic["client_batch"]
        self.steps_per_unit = self.y.shape[1] // self.batch
        self.samples_per_unit = self.y.shape[0] * self.steps_per_unit \\
            * self.batch

    def step(self, i):
        sl = slice(i * self.batch, (i + 1) * self.batch)
        p = {k: v.detach().requires_grad_() for k, v in self.p.items()}
        a = torch.relu(torch.einsum("cbi,cih->cbh", self.x[:, sl],
                                    p["client.w"])).flatten(0, 1)
        perm = torch.randperm(a.shape[0], generator=self.perm_gen)
        loss = F.cross_entropy(Shuffle.apply(a, perm) @ p["server.w"],
                               self.y[:, sl].flatten()[perm])
        loss.backward()
        self.p = {k: (v - self.lr * v.grad).detach() for k, v in p.items()}
        return loss.detach(), {k: v.grad for k, v in p.items()}

    def epoch(self, steps, first=0):
        out = [self.step(first + i) for i in range(steps)]
        self.p = fedavg(self.p)
        return out

    def unit(self):
        return torch.stack([ls for ls, _ in self.epoch(self.steps_per_unit)])

    def free(self):
        self.x = self.y = self.p = None


def checked(cell, seed, dev):
    r = Runner(cell, seed, dev)
    start, steps, at = dict(r.p), [], 0
    for n in cell.traffic["check_epochs"]:
        steps += r.epoch(n, at)
        at += n
    return r, {"losses": [float(ls) for ls, _ in steps],
               "grads": steps[0][1], "start": start, "params": dict(r.p)}


def reference(cell, seed, dev, dtype=torch.float32, frozen=False):
    x, y, p, perm_gen = make(cell, seed, dev)
    start = dict(p)
    x, p = x.to(dtype), {k: v.to(dtype) for k, v in p.items()}
    lr, b = cell.config["optimizer"]["lr"], cell.traffic["client_batch"]
    losses, first, at = [], None, 0
    for n in cell.traffic["check_epochs"]:
        for i in range(at, at + n):
            xs, ys = x[:, i * b:(i + 1) * b], y[:, i * b:(i + 1) * b]
            h = torch.einsum("cbi,cih->cbh", xs, p["client.w"])
            a = torch.relu(h).flatten(0, 1)
            perm = torch.randperm(a.shape[0], generator=perm_gen)
            s, yp = a[perm], ys.flatten()[perm]        # shuffled at the cut
            prob = torch.softmax((s @ p["server.w"]).float(), -1)
            losses.append(float(-prob[torch.arange(len(yp)), yp].log()
                                .mean()))
            dlogit = ((prob - F.one_hot(yp, prob.shape[1])) / len(yp)).to(
                dtype)
            ds = dlogit @ p["server.w"].T
            da = torch.empty_like(ds)
            da[perm] = ds                         # de-shuffled on the way back
            dh = da.reshape(h.shape) * (h > 0)
            g = {"client.w": torch.einsum("cbi,cbh->cih", xs, dh),
                 "server.w": s.T @ dlogit}
            first = first or {k: v.float() for k, v in g.items()}
            if not frozen:
                p = {k: p[k] - lr * g[k] for k in p}
        p, at = fedavg(p), at + n
    return {"losses": losses, "grads": first, "start": start,
            "params": {k: v.float() for k, v in p.items()}}


def numbers(got, want):
    def err(a, b):
        return float(torch.linalg.vector_norm((a - b).double())
                     / torch.linalg.vector_norm(b.double()))
    step = lambda o, k: o["params"][k] - o["start"][k]
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in
                            zip(got["losses"], want["losses"])),
            "grad_err": max(err(got["grads"][k], want["grads"][k])
                            for k in want["grads"]),
            "update_err": max(err(step(got, k), step(want, k))
                              for k in want["params"])}
'''
MLP_LIMITS = {"loss_gap": 1e-4, "grad_err": 1e-4, "update_err": 1e-4,
              "nonfinite": 0}


def mlp_tree(tmp_path, back="inverse"):
    """A copy of the benchmark's files with a second model family added as
    files and entries only: ``split_mlp``, a two-part MLP on seeded
    vectors, 4 clients of 32, batch 8, in the cell ``mlp.cpu``. ``back``:
    the backward of its cut's shuffle, ``"inverse"`` or (a planted fault)
    ``"again"``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "bench"
    (b / "configs" / "tiny-mlp.json").write_text(json.dumps(
        {"name": "tiny-mlp",
         "model": {"arch": "split_mlp", "in_dim": 8, "hidden": 16,
                   "num_classes": 4},
         "deployment": {"clients": 4, "samples_per_client": 32},
         "optimizer": {"lr": 0.5}}))
    (b / "traffic" / "mlp_b8.json").write_text(json.dumps(
        {"client_batch": 8, "check_epochs": [1, 2], "trace_epochs": 1}))
    (b / "workloads" / "mlp.cpu.json").write_text(json.dumps(
        {"limits": MLP_LIMITS}))
    (b / "programs" / "split_mlp.py").write_text(
        MLP_PROGRAM.replace("{back!r}", repr(back)))
    (b / "metrics" / "mlp.kernel_count.py").write_text(
        "def read(trace):\n    return len(trace.kernels) or None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-mlp", "source": "test",
                             "file": "bench/configs/tiny-mlp.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "mlp.cpu", "config": "tiny-mlp",
                               "traffic": "mlp_b8", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("mlp.cpu")
    bench["per_layer"].append({"name": "mlp.kernel_count",
                               "unit": "kernels", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "train_samples_per_s",
                               "workloads": ["mlp.cpu"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def _without(bench, cell):
    """``BENCHMARK.json`` with the entries that name ``cell``, its
    configuration and metrics taken out, and ``cell`` out of every
    ``workloads`` list."""
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    out = dict(bench)
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        out[key] = [{**e, **({"workloads": [w for w in e["workloads"]
                                            if w != cell]}
                             if "workloads" in e else {})}
                    for e in bench[key]
                    if e["name"] not in (cell, entry["config"])
                    and e.get("workloads") != [cell]]
    return out


def test_a_second_family_runs_from_new_files_only(tmp_path):
    root = mlp_tree(tmp_path)
    result, checks = run.execute("mlp.cpu", 2 ** 31 + 313, 0.2, 0,
                                 device="cpu", root=root)
    assert result["correct"], checks
    assert list(checks) == list(MLP_LIMITS)
    assert result["failed"] == 0 and result["attempted"] >= 3 + 4
    assert result["metrics"]["train_samples_per_s"]["value"] > 0
    for path in (ROOT / "bench").rglob("*"):
        rel = path.relative_to(ROOT)
        if path.is_file() and not {"__pycache__", "tests"} & set(rel.parts):
            assert (root / rel).read_bytes() == path.read_bytes(), rel
    assert _without(json.loads((root / "BENCHMARK.json").read_text()),
                    "mlp.cpu") == BENCH


def test_a_second_family_with_its_shuffle_not_undone_is_not_correct(
        tmp_path):
    root = mlp_tree(tmp_path, back="again")
    result, checks = run.execute("mlp.cpu", 2 ** 31 + 313, 0.1, 0,
                                 device="cpu", root=root)
    assert not result["correct"], checks
    assert checks["grad_err"]["value"] > checks["grad_err"]["limit"]


@pytest.mark.parametrize("workload", ["tiny.cpu", "mlp.cpu"])
def test_calibrate_reads_the_program_and_every_fault(tmp_path, workload):
    root = (tiny_tree if workload == "tiny.cpu" else mlp_tree)(tmp_path)
    cell = spec.Cell(workload, root)
    faults = cell.program().FAULTS
    got = calibrate.readings(workload, [41], [41], device="cpu", root=root)
    assert list(got) == ["program", *faults]
    assert all([r["seed"] for r in rows] == [41] for rows in got.values())
    ok = {key: compare.judge({**rows[0], "nonfinite": 0}, cell.limits)[0]
          for key, rows in got.items()}
    assert ok["program"] and not ok["control"], got


def _no_module_tree(tmp_path):
    """``tiny_tree`` with the tiny configuration's arch one that has no
    program module."""
    root = tiny_tree(tmp_path)
    path = root / "bench" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    cfg["model"]["arch"] = "no_such_arch"
    path.write_text(json.dumps(cfg))
    return root


def test_an_arch_without_a_program_module_is_named(tmp_path):
    root = _no_module_tree(tmp_path)
    with pytest.raises(FileNotFoundError,
                       match=r"'no_such_arch'.*programs/no_such_arch\.py"):
        spec.Cell("tiny.cpu", root).program()


def test_run_prints_no_result_for_an_arch_without_a_module(tmp_path):
    root = _no_module_tree(tmp_path)
    (root / "src").symlink_to(ROOT / "src")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "tiny.cpu",
         "--seed", "7", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=root)
    assert out.returncode == 1
    assert out.stdout == ""
    assert "no program module for model.arch 'no_such_arch'" in out.stderr


def test_the_resnet_module_reads_as_the_functions_it_adapts(tmp_path):
    """``tiny.cpu`` through ``run.execute`` and through the module's calls
    gives the numbers of ``run.checked_program`` and
    ``run.checked_reference`` at the same seed."""
    root = tiny_tree(tmp_path)
    seed = 2 ** 31 + 977
    cell = spec.Cell("tiny.cpu", root)
    dev = torch.device("cpu")
    old = compare.numbers(run.checked_program(cell, seed, dev)[-1],
                          run.checked_reference(cell, seed, dev))
    _, checks = run.execute("tiny.cpu", seed, 0.1, 0, device="cpu",
                            root=root)
    assert {k: c["value"] for k, c in checks.items() if k != "nonfinite"} \
        == {k: old[k] for k in checks if k != "nonfinite"}
    program = cell.program()
    runner, got = program.checked(cell, seed, dev)
    runner.free()
    assert program.numbers(got, program.reference(cell, seed, dev)) == old
