"""CPU tests of ``bench/spans.py`` and the readers of the program's spans
and counters, on synthetic Chrome events."""
import sys
import types

import pytest

from bench import spans, spec, tracing, yardstick

CELLS = ["r56_c100.train_b128", "r32_c10.train_b128"]
FAMS = list(yardstick.KERNEL_SYMBOLS)


def _row(name, ts, dur, tid=1, cat="cpu_op", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts),
            "dur": float(dur), "tid": tid, "pid": 1, "args": args}


def _launch(ts, corr, dur, tid=1, name="k"):
    """A launch call at ``ts`` on ``tid`` and its kernel, ``dur`` long."""
    return [_row("cudaLaunchKernel", ts, 1, tid, "cuda_runtime",
                 correlation=corr),
            _row(name, 5000 + 100 * corr, dur, 7, "kernel",
                 correlation=corr)]


def _trace(events, cell="r56_c100.train_b128", steps=1):
    window = _row(tracing.WINDOW, 0, 1e5, 1, "user_annotation")
    return tracing.Trace([window] + events, cell=spec.Cell(cell),
                         steps=steps, samples=1)


def _step_events():
    """Main thread 1: an operator outside any span takes sequence number 7
    without making its node; ``var_mean`` under ``bn.stats`` makes it and
    launches a 10 us kernel; a ``_BnAct`` under ``bn.act`` (number 8)
    launches 10 us; a convolution 60 us; the server's ``optim.sgd`` one
    kernel. Autograd thread 2: ``VarMeanBackward0`` (number 7) launches
    30 us, the convolution's backward (number 9) 40 us, and a second
    ``optim.sgd`` one kernel."""
    ev = [_row("aten::to", 90, 5, **{"Sequence number": 7}),
          _row("bn.stats", 100, 100),
          _row("aten::var_mean", 110, 40, **{"Sequence number": 7}),
          *_launch(120, 1, 10),
          _row("bn.act", 210, 50),
          _row("_BnAct", 215, 40, **{"Sequence number": 8}),
          *_launch(220, 2, 10),
          _row("aten::convolution", 300, 50, **{"Sequence number": 9}),
          *_launch(310, 3, 60),
          _row(spans.EVALUATE + "VarMeanBackward0", 500, 100, 2,
               **{"Sequence number": 7}),
          _row("VarMeanBackward0", 505, 90, 2, **{"Sequence number": 7}),
          *_launch(550, 4, 30, 2),
          _row(spans.EVALUATE + "ConvolutionBackward0", 610, 80, 2,
               **{"Sequence number": 9}),
          *_launch(620, 5, 40, 2),
          _row("optim.sgd", 700, 100),
          _row("aten::mul", 710, 20),
          *_launch(715, 6, 5),
          _row("optim.sgd", 800, 100, 2),
          *_launch(815, 7, 5, 2)]
    return ev


@pytest.mark.parametrize("metric,want", [
    # of 160 us of kernels: bn.stats 10 forward + 30 backward on thread 2,
    # bn.act 10
    ("train.bn_device_pct", 100 * 50 / 160),
    ("train.bn_stats_device_pct", 100 * 40 / 160)])
def test_bn_time_charges_forward_and_backward_kernels(metric, want):
    tr = _trace(_step_events())
    assert spec.Cell(CELLS[0]).reader(metric)(tr) == pytest.approx(want)


def test_backward_kernel_goes_to_its_forward_operators_span():
    tr = _trace(_step_events())
    names = spans.charged_spans(tr, ("bn.",))
    by_corr = {e["args"]["correlation"]: n for e, n in zip(tr.kernels,
                                                           names)}
    assert by_corr == {1: "bn.stats", 2: "bn.act", 3: None, 4: "bn.stats",
                       5: None, 6: None, 7: None}


@pytest.mark.parametrize("steps", [1, 2])
def test_optimizer_launches_counted_on_both_threads(steps):
    tr = _trace(_step_events(), cell=CELLS[1], steps=steps)
    read = spec.Cell(CELLS[1]).reader("host.opt_launches_per_step")
    assert read(tr) == 2 / steps


@pytest.mark.parametrize("metric,cell", [
    ("train.bn_device_pct", CELLS[0]), ("train.bn_stats_device_pct",
                                        CELLS[0]),
    ("host.opt_launches_per_step", CELLS[1]),
    ("train.kernels_counted_roofline_pct", CELLS[0])])
def test_readers_leave_out_what_the_program_does_not_record(
        monkeypatch, metric, cell):
    """A program without the spans (the rows stripped) or without the
    counters (no ``repro_torch.trace`` module) gives nothing to read."""
    bare = [e for e in _step_events()
            if not e["name"].startswith(("bn.", "optim."))]
    sym = yardstick.KERNEL_SYMBOLS["collector_permute"]
    bare += _launch(900, 8, 10, name=f"void {sym}<x>")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    tr = _trace(bare, cell=cell)
    assert spec.Cell(cell).reader(metric)(tr) is None


def _counters(per_step, steps):
    return types.SimpleNamespace(COUNTERS={
        "bytes": {f: per_step[f] * steps for f in FAMS},
        "sfpl": {"steps": steps}})


@pytest.mark.parametrize("traced_steps", [1, 3])
def test_counted_roofline_reads_bytes_a_step(monkeypatch, traced_steps):
    """Bytes a step from the counters (any number of steps counted) times
    the traced steps, over the bandwidth, over the four families' device
    time, whatever their launch counts."""
    per_step = {"collector_permute": 4e6, "bn_act": 3e7, "xent_fwd": 1e5,
                "xent_bwd": 2e5}
    monkeypatch.setitem(sys.modules, "repro_torch.trace",
                        _counters(per_step, 17))
    ev, corr = [], 100
    for fam, sym in yardstick.KERNEL_SYMBOLS.items():
        for _ in range(3):              # launch counts no yardstick gives
            ev += _launch(10 * corr, corr, 20.0, name=f"void {sym}<x>")
            corr += 1
    tr = _trace(ev, steps=traced_steps)
    device = 4 * 3 * 20e-6
    want = 100 * sum(per_step.values()) * traced_steps \
        / yardstick.HBM_BYTES_PER_S / device
    read = spec.Cell(CELLS[0]).reader("train.kernels_counted_roofline_pct")
    assert read(tr) == pytest.approx(want)
