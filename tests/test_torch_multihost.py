"""The port's multi-process bring-up and crash recovery (CPU, gloo).

  1. ``launch.multihost.initialize`` retries a flaky join (a stand-in
     ``torch.distributed.init_process_group``) with the deterministic
     backoff seeded by the process id, destroys the half-made group
     between attempts, and raises ``RetryError`` naming the join once the
     budget is spent (the twin of tests/test_multihost_faults.py's retry
     tests);
  2. kill-and-resume over 2 real ranks spawned with
     ``torch.multiprocessing``, joined through ``initialize`` on a
     ``file://`` FileStore, with seeded dropouts every epoch
     (tests/_torch_fault_worker.py): an uninterrupted 3-epoch run; the
     same run under ``FaultPlan(kill_process=1, kill_epoch=2)`` — rank 1
     SIGKILLs itself at the start of epoch 2, after the epoch-1
     checkpoint is on disk; a fresh pair that restores it and finishes.
     The resumed losses and final states must match the uninterrupted
     run within 1e-5 (the JAX package's twin of this test fails on the
     installed jax, ROADMAP section 3, so the port's own uninterrupted
     run is the reference). Every join has a timeout: a hang fails the
     test instead of stalling the suite.
"""
import os
import pickle
import signal

import numpy as np
import pytest
import torch

import _torch_fault_worker as W
from repro_torch.core.retry import RetryError, backoff_schedule

JOIN_S = 120


# --------------------------------------------------------------------------
# 1. retry / backoff on the join


def _patched_join(monkeypatch, fail_first, process_id=1, attempts=4):
    import torch.distributed as dist
    from repro_torch.launch import multihost
    calls, downs, slept = [], [], []
    half_made = []

    def fake_init(backend, **kw):
        calls.append(dict(kw, backend=backend))
        if len(calls) <= fail_first:
            half_made.append(1)       # a group left half set up
            raise RuntimeError(f"connect refused {len(calls)}")

    def fake_destroy():
        downs.append(1)
        half_made.clear()

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "is_initialized", lambda: bool(half_made))
    monkeypatch.setattr(dist, "destroy_process_group", fake_destroy)
    multihost.initialize("127.0.0.1:1", num_processes=2,
                         process_id=process_id, backend="gloo",
                         connect_attempts=attempts, connect_base_delay=0.25,
                         connect_max_delay=2.0, sleep=slept.append)
    return calls, downs, slept


def test_initialize_retries_with_deterministic_backoff(monkeypatch):
    calls, downs, slept = _patched_join(monkeypatch, fail_first=2)
    assert len(calls) == 3           # 2 transient failures + 1 success
    assert len(downs) == 2           # half-made group reset each failure
    assert slept == backoff_schedule(4, base_delay=0.25, max_delay=2.0,
                                     seed=1)[:2]
    assert all(kw["init_method"] == "tcp://127.0.0.1:1"
               and kw["rank"] == 1 and kw["world_size"] == 2
               and kw["backend"] == "gloo" for kw in calls)
    # different processes jitter differently (decorrelated herd)
    _, _, slept0 = _patched_join(monkeypatch, fail_first=2, process_id=0)
    assert slept0 != slept


def test_initialize_exhausts_budget(monkeypatch):
    import torch.distributed as dist
    from repro_torch.launch import multihost

    def always_down(backend, **kw):
        raise ConnectionError("coordinator unreachable")

    monkeypatch.setattr(dist, "init_process_group", always_down)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    with pytest.raises(RetryError, match="process 1/2") as ei:
        multihost.initialize("127.0.0.1:1", num_processes=2, process_id=1,
                             connect_attempts=3, sleep=lambda _: None)
    assert ei.value.attempts == 3
    assert isinstance(ei.value.last, ConnectionError)


def test_host_value_without_a_group():
    from repro_torch.launch.multihost import host_value
    x = torch.tensor([[1.5, -2.0]], dtype=torch.bfloat16)
    for sharded in (False, True):
        got = host_value(x, sharded=sharded)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, [[1.5, -2.0]])


# --------------------------------------------------------------------------
# 2. kill-and-resume across spawned ranks


def _start(tmp_path, mode, ckpt):
    ctx = torch.multiprocessing.get_context("spawn")
    out = tmp_path / mode
    out.mkdir()
    url = "file://" + str(tmp_path / f"{mode}.store")
    procs = [ctx.Process(target=W.run,
                         args=(r, 2, url, mode, ckpt, str(out)))
             for r in range(2)]
    for p in procs:
        p.start()
    return procs, out


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=JOIN_S)


def _results(procs, out):
    try:
        for p in procs:
            p.join(timeout=JOIN_S)
        assert not any(p.is_alive() for p in procs), "a rank hung"
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        _stop(procs)
    res = []
    for r in range(2):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def test_kill_and_resume_matches_uninterrupted(tmp_path):
    ckpt = str(tmp_path / "state.npz")
    full_procs, full_out = _start(tmp_path, "full", None)
    fault_procs, fault_out = _start(tmp_path, "fault", ckpt)
    try:
        fault_procs[1].join(timeout=JOIN_S)
        assert fault_procs[1].exitcode == -signal.SIGKILL, \
            fault_procs[1].exitcode
        # rank 0 waits on a peer that is gone: gloo errors out, or the
        # process is ended here
        fault_procs[0].join(timeout=30)
    finally:
        _stop(fault_procs)
    assert not os.listdir(fault_out), "the killed pair reported results"
    full = _results(full_procs, full_out)

    with np.load(ckpt) as f:
        assert int(f["__step__"]) == W.KILL["kill_epoch"]
    assert [n for n in os.listdir(tmp_path) if ".tmp" in n] == []

    resumed = _results(*_start(tmp_path, "resume", ckpt))
    for r in range(2):
        assert sorted(full[r]["losses"]) == [0, 1, 2]
        assert resumed[r]["start"] == 2
        assert sorted(resumed[r]["losses"]) == [2]   # one lost epoch
        np.testing.assert_array_equal(resumed[r]["masks"][2],
                                      full[r]["masks"][2])
        np.testing.assert_allclose(resumed[r]["losses"][2],
                                   full[r]["losses"][2], rtol=1e-5,
                                   atol=1e-5)
        for key in ("cp", "sp", "sopt"):
            for a, b in zip(resumed[r][key], full[r][key]):
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                           err_msg=key)
    # both ranks agree on the recovered trajectory and the whole clients
    np.testing.assert_array_equal(resumed[0]["losses"][2],
                                  resumed[1]["losses"][2])
    for a, b in zip(resumed[0]["cp"], resumed[1]["cp"]):
        np.testing.assert_array_equal(a, b)
    assert resumed[0]["cp"][0].shape[0] == W.V
    # the masks drop clients: the run was elastic
    assert not all(m.all() for m in full[0]["masks"].values())
