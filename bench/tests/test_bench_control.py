"""The control and the planted faults come out not correct.

On the card (marked ``cuda``; skips here), at each cell's own size on
three seeds: the plain reference computed with fp8 products (one step
below the configurations' bfloat16) put in the program's place, half of
the pool left out of the loss (the second half of the clients' rows, or
the second half of the shuffled rows), and a state left unchanged, each
judged by the cell's own limits. Run there with

    python -m pytest --noconftest -m cuda bench/tests/test_bench_control.py

On the CPU, a whole run of a tiny cell (``test_bench_harness.tiny_tree``)
with the program broken underneath (a state returned unchanged, or the
server's step on the first half of the shuffled pool), and the control
in the program's place, each come out not correct.
"""
import pytest
import torch

from bench import calibrate, compare, run, spec, sut
from bench.tests.test_bench_harness import BENCH, tiny_tree


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_and_faults_fail_on_the_card(card, workload):
    cell = spec.Cell(workload)
    got = calibrate.readings(workload, [], [21001, 21002, 21003], card)
    for kind in ("control", "half_batch", "half_rows", "frozen"):
        for row in got[kind]:
            ok, checks = compare.judge({**row, "nonfinite": 0}, cell.limits)
            assert not ok, (kind, row)


def _half_rows(split):
    """The server loss over the first half of the shuffled pool only."""
    def server_loss(sp, ss, a, y, *args, **kw):
        h = a.shape[0] // 2
        return split.server_loss(sp, ss, a[:h], y[:h], *args, **kw)
    return type(split)(split.client_fwd, server_loss, split.full_loss)


def _frozen(epoch):
    """An epoch that runs but returns the state it was given."""
    def frozen(self, gen, st, data):
        _, losses = epoch(self, gen, st, data)
        return st, losses
    return frozen


@pytest.mark.parametrize("fault", ["frozen", "half_rows"])
def test_a_broken_program_is_not_correct(tmp_path, monkeypatch, fault):
    root = tiny_tree(tmp_path)
    if fault == "frozen":
        monkeypatch.setattr(sut.Program, "epoch",
                            _frozen(sut.Program.epoch))
    else:
        init = sut.Program.__init__

        def broken(self, *a, **kw):
            init(self, *a, **kw)
            self.split = _half_rows(self.split)
        monkeypatch.setattr(sut.Program, "__init__", broken)
    result, checks = run.execute("tiny.cpu", 31, 0.1, 0, device="cpu",
                                 root=root)
    assert not result["correct"], checks


def test_the_control_in_the_programs_place_is_not_correct(tmp_path):
    root = tiny_tree(tmp_path)
    cell = spec.Cell("tiny.cpu", root)
    dev = torch.device("cpu")
    for seed in (41, 42, 43):
        want = run.checked_reference(cell, seed, dev)
        got = run.checked_reference(cell, seed, dev, precision="fp8")
        ok, _ = compare.judge({**compare.numbers(got, want),
                               "nonfinite": 0}, cell.limits)
        assert not ok
