"""CPU tests of the split-LM program module (``bench/programs/split_lm.py``)
at a tiny afmoe configuration, of its metric readers on synthetic Chrome
events, and of ``bench/lm_yardstick.py`` against hand counts. One card
test (marked ``cuda``) holds the flex attention path against the plain
one and counts the MoE step's synchronisations.

    python -m pytest --noconftest -m cuda bench/tests/test_bench_split_lm.py
"""
import json
import shutil
import types

import pytest
import torch

from bench import lm_yardstick as L
from bench import run, spans, spec, tracing
from bench.tests.test_bench_harness import BENCH, ROOT

CELL = "trinity_ep8.train_s8k_c8"
TINY = {"hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2,
        "head_dim": 16, "intermediate_size": 96, "moe_intermediate_size": 32,
        "num_hidden_layers": 6, "sliding_window": 4, "vocab_size": 64,
        "num_experts_per_tok": 2, "num_experts": 4}
TINY_DEP = {"router_experts": 8, "experts_held": [2, 4]}
TINY_LIMITS = {"loss_gap": 1e-5, "head_grad_err": 1e-4,
               "grad_median_err": 1e-4, "route_miss": 1e-9, "nonfinite": 0}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors (the suite runs several
    workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lm_tree(tmp_path):
    """A copy of the benchmark's files with the cell ``lm.cpu`` added as
    files and entries only: the trinity configuration at tiny widths (6
    layers, 8 router outputs, the experts 2-5 held), 4 clients of one
    16-token sequence, computed in float32 and held to ``TINY_LIMITS``."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "src").symlink_to(ROOT / "src")
    b = tmp_path / "bench"
    cfg = json.loads((b / "configs" / "sfpl-trinity-mini-ep8.json")
                     .read_text())
    cfg.update(TINY, name="tiny-lm")
    cfg["deployment"].update(TINY_DEP)
    cfg["precision"]["compute_dtype"] = "float32"
    (b / "configs" / "tiny-lm.json").write_text(json.dumps(cfg))
    (b / "traffic" / "lm_s16.json").write_text(json.dumps(
        {"clients": 4, "seq_len": 16, "check_epochs": [1, 1],
         "trace_epochs": 1}))
    (b / "workloads" / "lm.cpu.json").write_text(json.dumps(
        {"limits": TINY_LIMITS}))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-lm", "source": "test",
                             "file": "bench/configs/tiny-lm.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "lm.cpu", "config": "tiny-lm",
                               "traffic": "lm_s16", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("lm.cpu")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return lm_tree(tmp_path_factory.mktemp("lm"))


# --------------------------------------------------------------------------
# the module's contract

def test_the_cell_names_its_files_and_limits():
    cell = spec.Cell(CELL)
    program = cell.program()
    assert cell.config["model"]["arch"] == "split_lm"
    assert set(cell.limits) >= {"loss_gap", "head_grad_err", "nonfinite"}
    assert {"control", "all_full", "rope_everywhere", "no_attn_gate",
            "no_route_norm", "top1"} <= set(program.FAULTS)
    assert [m["name"] for m in cell.per_layer()] == [
        "lm.mfu_pct", "lm.moe_device_pct", "lm.attn_device_pct",
        "lm.expert_mm_roofline_pct", "lm.attn_roofline_pct"]
    assert {m["name"] for m in cell.end_to_end()} == {
        "train_samples_per_s", "peak_mem_gib", "setup_s"}


def test_the_configuration_keeps_every_published_width():
    """Every number of the published config.json that is not listed in
    ``reduced`` is as published; the cut keys state the published value
    beside them."""
    c = spec.Cell(CELL).config
    published = {"global_attn_every_n_layers": 4, "head_dim": 128,
                 "hidden_size": 2048, "intermediate_size": 6144,
                 "load_balance_coeff": 0.001, "moe_intermediate_size": 1024,
                 "num_attention_heads": 32, "num_dense_layers": 2,
                 "num_experts_per_tok": 8, "num_key_value_heads": 4,
                 "num_shared_experts": 1, "rms_norm_eps": 1e-5,
                 "rope_theta": 10000, "route_scale": 2.826,
                 "sliding_window": 2048}
    assert {k: c[k] for k in published} == published
    entry = next(e for e in BENCH["configs"] if e["name"] == c["name"])
    assert set(entry["reduced"]) == set(c["reduced"])
    for k in c["reduced"]:
        assert k in c["deployment"]["published"]
    assert c["deployment"]["router_experts"] == 128
    assert c["deployment"]["experts_held"] == [0, c["num_experts"]]


def test_the_module_runs_its_contract_on_the_cpu(tree):
    cell = spec.Cell("lm.cpu", tree)
    program = cell.program()
    dev = torch.device("cpu")
    seed = 2 ** 31 + 77
    runner, got = program.checked(cell, seed, dev)
    assert runner.samples_per_unit == 4 and runner.steps_per_unit == 1
    losses = runner.unit()
    assert losses.shape == (1,) and torch.isfinite(losses).all()
    runner.free()
    assert len(got["losses"]) == 2
    assert got["choices"].shape == (4 * 16, 2)
    want = program.reference(cell, seed, dev)
    assert set(got["first_grad"]) == set(want["first_grad"])
    assert set(got["params"]) == set(want["params"])
    nums = program.numbers(got, want)
    for k in ("loss_gap", "grad_median_gap", "update_median_gap",
              "route_agree", "head_grad_err", "bias_err"):
        assert k in nums
    # float32 on both sides at this size: the same numbers to round-off
    assert nums["route_agree"] == 1.0
    assert nums["loss_gap"] < 1e-5 and nums["grad_err"] < 1e-3
    assert nums["update_err"] < 1e-3 and nums["bias_err"] < 1e-5


def test_the_held_load_of_every_step_is_read(tree):
    """``held_load`` holds each checked step's and each unit's held rows
    over the held experts' even share (top-k x held / experts of the
    token-slots), as the forward's routing counts them; ``numbers``
    reads the worst step's gap from 1, and 0 for the reference, which
    takes no steps of its own."""
    from repro_torch.nn.moe import record_routing
    cell = spec.Cell("lm.cpu", tree)
    program = cell.program()
    dev = torch.device("cpu")
    seed = 2 ** 31 + 78
    runner, got = program.checked(cell, seed, dev)
    with record_routing() as rec:
        runner.unit()
    runner.unit()
    runner.free()
    load = got["held_load"]
    assert len(load) == 4 and all(v > 0 for v in load)
    (lo, n), E = TINY_DEP["experts_held"], TINY_DEP["router_experts"]
    held = sum(int(c[lo:lo + n].sum()) for c in rec.counts)
    slots = sum(int(c.sum()) for c in rec.counts)
    assert load[2] == pytest.approx(held / (slots * n / E))
    want = program.reference(cell, seed, dev)
    assert program.numbers(got, want)["held_load_gap"] == pytest.approx(
        max(abs(v - 1) for v in load))
    assert program.numbers(want, want)["held_load_gap"] == 0.0


def test_run_execute_is_correct_on_the_cpu(tree):
    result, checks = run.execute("lm.cpu", 2 ** 31 + 5, 0.2, 0,
                                 device="cpu", root=tree)
    assert result["correct"], checks
    assert list(checks) == list(TINY_LIMITS)
    assert result["metrics"]["train_samples_per_s"]["value"] > 0
    assert result["failed"] == 0


@pytest.mark.parametrize("fault", ["control", "all_full", "rope_everywhere",
                                   "no_attn_gate", "no_route_norm", "top1",
                                   "half_batch", "half_rows", "frozen"])
def test_each_fault_fails_a_limit_at_the_tiny_size(tree, fault):
    cell = spec.Cell("lm.cpu", tree)
    program = cell.program()
    dev = torch.device("cpu")
    want = program.reference(cell, 2 ** 31 + 11, dev)
    got = program.reference(cell, 2 ** 31 + 11, dev, **program.FAULTS[fault])
    nums = {**program.numbers(got, want), "nonfinite": 0}
    assert any(nums[k] > v for k, v in TINY_LIMITS.items()), (fault, nums)


def test_a_tree_without_the_ports_fields_fails_on_import(tmp_path,
                                                         monkeypatch):
    """The module checks the port's config fields when it is loaded, so a
    port without them fails before any set-up."""
    from repro_torch.models import common
    fields = dict(common.AfmoeConfig.__dataclass_fields__)
    fields.pop("experts_held")
    monkeypatch.setattr(common.AfmoeConfig, "__dataclass_fields__", fields)
    with pytest.raises(ImportError, match="experts_held"):
        spec.Cell(CELL).program()


# --------------------------------------------------------------------------
# the readers, on synthetic events

def _row(name, ts, dur, tid=1, cat="cpu_op", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts),
            "dur": float(dur), "tid": tid, "pid": 1, "args": args}


def _launch(ts, corr, dur, tid=1, name="k"):
    return [_row("cudaLaunchKernel", ts, 1, tid, "cuda_runtime",
                 correlation=corr),
            _row(name, 5000 + 100 * corr, dur, 7, "kernel",
                 correlation=corr)]


ROWS = 6000       # the rows of each grouped product in the forward


def _lm_events():
    """Main thread: ``attn.core`` launches 40 us, ``moe.route`` 5,
    ``moe.experts`` 30 (its three grouped products of ``ROWS`` rows, the
    first with sequence number 3), a head product 25; the autograd
    thread: the grouped product's backward 60 us, whose own grouped
    product of 9,999 rows is no forward's."""
    dims = {"Input Dims": [[ROWS, 2048], [16, 2048, 1024], [16]]}
    return [_row("attn.core", 100, 50), *_launch(110, 1, 40),
            _row("moe.route", 200, 20), *_launch(205, 2, 5),
            _row("moe.experts", 300, 50),
            _row("aten::_grouped_mm", 305, 20, **{"Sequence number": 3},
                 **dims),
            *_launch(310, 3, 30),
            _row("aten::_grouped_mm", 330, 5, **dims),
            _row("aten::_grouped_mm", 340, 5, **dims),
            *_launch(400, 4, 25),
            _row(spans.EVALUATE + "GroupedMmBackward0", 600, 100, 2,
                 **{"Sequence number": 3}),
            _row("aten::_grouped_mm", 605, 50, 2,
                 **{"Input Dims": [[9999, 2048], [16, 2048, 1024], [16]]}),
            *_launch(610, 5, 60, 2)]


def _trace(events, steps=1, busy_s=None):
    window = _row(tracing.WINDOW, 0, 1e5, 1, "user_annotation")
    busy = None
    if busy_s is not None:
        busy = types.SimpleNamespace(busy_s=busy_s, samples=8 * steps)
    return tracing.Trace([window] + events, cell=spec.Cell(CELL),
                         steps=steps, samples=8 * steps, busy=busy)


@pytest.mark.parametrize("metric,want", [
    # of 160 us of kernels: moe 5 + 30 + 60, attn 40
    ("lm.moe_device_pct", 100 * 95 / 160),
    ("lm.attn_device_pct", 100 * 40 / 160)])
def test_device_shares_charge_forward_and_backward(metric, want):
    read = spec.Cell(CELL).reader(metric)
    assert read(_trace(_lm_events())) == pytest.approx(want)


@pytest.mark.parametrize("steps", [1, 2])
def test_held_rows_are_the_forwards_grouped_rows(steps):
    """The forward's three products of ``ROWS`` rows, over the steps and
    the 8 MoE layers; the backward's product is not counted."""
    tr = _trace(_lm_events(), steps)
    assert L.forward_held_rows(tr) == pytest.approx(ROWS / steps / 8)


@pytest.mark.parametrize("steps", [1, 2])
def test_expert_roofline_reads_forward_rows_over_charged_time(steps):
    cfg = spec.Cell(CELL).config
    read = spec.Cell(CELL).reader("lm.expert_mm_roofline_pct")
    held = ROWS / steps / 8
    want = 100 * steps * L.expert_kernel_flops(cfg, held) / (90e-6 * L.PEAK)
    assert read(_trace(_lm_events(), steps)) == pytest.approx(want)


def test_attn_roofline_reads_window_aware_flops_over_charged_time():
    cell = spec.Cell(CELL)
    read = cell.reader("lm.attn_roofline_pct")
    want = 100 * L.attn_kernel_flops(cell.config, cell.traffic) \
        / (40e-6 * L.PEAK)
    assert read(_trace(_lm_events())) == pytest.approx(want)


def test_mfu_reads_model_flops_over_busy_time():
    cell = spec.Cell(CELL)
    read = cell.reader("lm.mfu_pct")
    want = 100 * 3 * L.step_model_flops(cell.config, cell.traffic,
                                        ROWS / 3 / 8) / (2.0 * L.PEAK)
    assert read(_trace(_lm_events(), steps=3, busy_s=2.0)) == \
        pytest.approx(want)


@pytest.mark.parametrize("metric", [
    "lm.mfu_pct", "lm.moe_device_pct", "lm.attn_device_pct",
    "lm.expert_mm_roofline_pct", "lm.attn_roofline_pct"])
def test_readers_leave_out_what_the_program_does_not_record(metric):
    """A program without the spans and the grouped products (the rows
    stripped, as a tree without the dropless MoE) reads nothing."""
    bare = [e for e in _lm_events()
            if not e["name"].startswith(("moe.", "attn.", "aten::_grouped"))]
    assert spec.Cell(CELL).reader(metric)(_trace(bare, busy_s=1.0)) is None


# --------------------------------------------------------------------------
# the yardstick against hand counts

@pytest.mark.parametrize("seq,window,want", [
    (8, None, 36), (8, 3, 3 + 3 * 5 + 3), (8192, 2048, 2048 * 2049 // 2
                                            + 6144 * 2048),
    (4, 8, 10)])
def test_keys_attended(seq, window, want):
    assert L.keys_attended(seq, window) == want


def test_step_flops_by_hand():
    """Trinity-Mini's cut at 8 x 8,192 tokens, one held row a token a
    layer on average (8 slots, 16 of 128 held): 4.12 GFLOP a token."""
    cell = spec.Cell(CELL)
    c, t = cell.config, cell.traffic
    tokens = 8 * 8192
    proj = 2 * 2048 * (3 * 4096 + 2 * 512) * 10
    dense = 6 * 2048 * 6144 * 2
    moe = (2 * 2048 * 128 + 6 * 2048 * 1024 + 6 * 2048 * 1024) * 8
    head = 2 * 2048 * 25024
    full, win = 8192 * 8193 // 2, 2048 * 2049 // 2 + 6144 * 2048
    attn = 8 * 4 * 4096 * (2 * full + 8 * win)
    want = 3 * (tokens * (proj + dense + moe + head) + attn)
    got = L.step_model_flops(c, t, held_rows=tokens)
    assert got == want
    assert got / tokens == pytest.approx(4.12e9, rel=1e-3)
    assert L.attn_kernel_flops(c, t) == 4.5 * attn
    assert L.expert_kernel_flops(c, tokens) == 4 * tokens * 6 * 2048 * 1024 * 8


# --------------------------------------------------------------------------
# on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flex_path_matches_the_plain_path_on_the_card(card):
    """Forward and gradients of the flex path against the plain chunked
    softmax at S 512, window 128 and full, GQA 8 / 2 heads of 128, bf16:
    the two differ by bf16 rounding of the output (2 ulps)."""
    from repro_torch.nn.attention import AttnConfig, attention_apply, \
        attention_init
    gen = torch.Generator(card).manual_seed(0)
    for window in (128, None):
        cfg = AttnConfig(d_model=256, num_heads=8, num_kv_heads=2,
                         head_dim=128, qk_norm=True, sliding_window=window,
                         out_gate=True)
        params = {k: {kk: v.to(torch.bfloat16) for kk, v in p.items()}
                  for k, p in attention_init(gen, cfg).items()}
        x = torch.randn(2, 512, 256, generator=gen, device=card,
                        dtype=torch.bfloat16)
        pos = torch.arange(512, device=card).expand(2, 512)
        outs = []
        for impl in ("xla", "flex"):
            xi = x.clone().requires_grad_()
            y = attention_apply(params, xi, AttnConfig(
                **{**cfg.__dict__, "impl": impl}), positions=pos)
            y.float().square().sum().backward()
            outs.append((y.float(), xi.grad.float()))
        (y0, g0), (y1, g1) = outs
        assert torch.allclose(y1, y0, rtol=2e-2, atol=2e-2), window
        assert float((g1 - g0).norm() / g0.norm()) < 2e-2, window


@pytest.mark.cuda
def test_moe_step_syncs_the_host_once_a_call(card):
    """A dropless MoE layer's forward and backward on the card under
    ``set_sync_debug_mode("warn")``: at most one synchronising call a
    forward call (the held rows' count)."""
    import warnings

    from repro_torch.nn.moe import moe_dropless_apply, moe_dropless_init
    gen = torch.Generator(card).manual_seed(0)
    p = moe_dropless_init(gen, 256, 128, 32, held=(8, 8))
    p = {k: (v.to(torch.bfloat16) if k not in ("router", "expert_bias")
             and torch.is_tensor(v) else v) for k, v in p.items()}
    p["shared"] = {k: {"w": v["w"].to(torch.bfloat16)}
                   for k, v in p["shared"].items()}
    x = torch.randn(4, 512, 256, generator=gen, device=card,
                    dtype=torch.bfloat16, requires_grad=True)
    moe_dropless_apply(p, x, num_experts=32, top_k=4, held=(8, 8))
    torch.cuda.synchronize()
    calls = 3
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(calls):
                y, _ = moe_dropless_apply(p, x, num_experts=32, top_k=4,
                                          held=(8, 8))
                y.float().sum().backward()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen
             if "called a synchronizing" in str(w.message)]
    assert len(syncs) <= calls, [str(w.message) for w in syncs]
