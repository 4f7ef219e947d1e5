"""Jittered exponential-backoff retry — the bring-up side of fault tolerance.

Multi-host bring-up is the one place the stack talks to an unreliable
outside world: ``torch.distributed.init_process_group`` races the
coordinator's listen socket, and on a flaky fabric the first join attempt
of a late process routinely lands on ECONNREFUSED.  ``retry_call`` wraps
any such call with capped exponential backoff plus deterministic jitter
(seeded, so N processes retrying the same coordinator decorrelate without
a shared clock), and raises a :class:`RetryError` naming the call, the attempt
budget, and the last underlying error once the budget is exhausted.

The clock is injectable (``sleep=``) so tests drive the schedule without
wall time; the jitter stream is seeded (``seed=``) so the schedule is
reproducible — both matter for the deterministic fault harness in
``core/faults.py``.
"""
from __future__ import annotations

import logging
import time

import numpy as np

_log = logging.getLogger(__name__)


class RetryError(RuntimeError):
    """Terminal failure after the retry budget is exhausted.

    ``last`` holds the final underlying exception (also chained via
    ``__cause__``), ``attempts`` the budget that was spent.
    """

    def __init__(self, message, *, attempts, last):
        super().__init__(message)
        self.attempts = attempts
        self.last = last


def backoff_schedule(attempts, *, base_delay=0.5, max_delay=30.0,
                     jitter=0.5, seed=0):
    """The exact delays ``retry_call`` would sleep between attempts.

    Deterministic in ``seed``; ``attempts - 1`` entries (no sleep after the
    final failure).  Delay i is ``min(max_delay, base_delay * 2**i)``
    stretched by a uniform factor in ``[1, 1 + jitter]``.

    >>> [round(d, 3) for d in backoff_schedule(3, base_delay=1.0, jitter=0.0)]
    [1.0, 2.0]
    """
    rng = np.random.default_rng(seed)
    out = []
    for i in range(max(0, attempts - 1)):
        delay = min(float(max_delay), float(base_delay) * (2.0 ** i))
        out.append(delay * (1.0 + float(jitter) * float(rng.random())))
    return out


def retry_call(fn, *, attempts=5, base_delay=0.5, max_delay=30.0,
               jitter=0.5, seed=0, retry_on=(Exception,), sleep=time.sleep,
               describe=None):
    """Call ``fn()`` with up to ``attempts`` tries and jittered backoff.

    Only exceptions matching ``retry_on`` are retried; anything else
    propagates immediately (a typo should not burn the whole budget).
    After the last failed attempt a :class:`RetryError` is raised from the
    final underlying exception, so the terminal traceback shows both the
    budget and the root cause.
    """
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    name = describe or getattr(fn, "__name__", "call")
    delays = backoff_schedule(attempts, base_delay=base_delay,
                              max_delay=max_delay, jitter=jitter, seed=seed)
    last = None
    for i in range(attempts):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — the loop IS the feature
            last = e
            if i == attempts - 1:
                break
            _log.warning("%s failed (attempt %d/%d): %r — retrying in %.2fs",
                         name, i + 1, attempts, e, delays[i])
            sleep(delays[i])
    raise RetryError(
        f"{name} failed after {attempts} attempt(s); backoff budget "
        f"exhausted. Last error: {last!r}", attempts=attempts,
        last=last) from last
