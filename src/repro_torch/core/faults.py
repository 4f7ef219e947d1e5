"""Deterministic fault injection for SFPL training runs.

A :class:`FaultPlan` is a SEEDED schedule of the three failure modes the
resource-constrained IoT setting exhibits: client dropouts, client
stragglers, and whole-process kills. Every draw derives from ``(seed,
epoch)`` through a fresh ``np.random.default_rng``, so any process — or a
test re-running the schedule after a crash — reconstructs the identical
fault sequence without shared state, and the masks and delays equal the
JAX package's bit for bit. That determinism is what lets the multi-rank
harness SIGKILL a worker mid-run and still compare the resumed run
against an uninterrupted one at 1e-5.

The plan is pure description: :meth:`FaultPlan.participation` returns the
epoch's surviving-client mask (and how long a waiting host would stall),
and :meth:`FaultPlan.maybe_kill` is the one effectful method — the
scheduled process SIGKILLs ITSELF, the honest simulation of a powered-off
worker (no cleanup handlers, no flushed buffers).
"""
from __future__ import annotations

import dataclasses
import os
import signal
from typing import Optional

import numpy as np

from repro_torch.core.collector import flush_group_sizes


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded per-epoch schedule of dropouts, stragglers, process kills.

    ``drop_rate`` / ``straggler_rate`` are per-(epoch, client)
    probabilities; a straggler answers after ``straggler_delay`` seconds.
    ``kill_process``/``kill_epoch`` schedule one SIGKILL: process
    ``kill_process`` dies at the start of epoch ``kill_epoch`` (mid-run,
    after earlier epochs' checkpoints exist).
    """
    num_clients: int
    seed: int = 0
    drop_rate: float = 0.0
    straggler_rate: float = 0.0
    straggler_delay: float = 1.0
    kill_process: Optional[int] = None
    kill_epoch: Optional[int] = None

    def _rng(self, epoch, salt):
        return np.random.default_rng((self.seed, int(epoch), salt))

    def available(self, epoch):
        """Bool mask: client did NOT drop out this epoch."""
        return self._rng(epoch, 0).random(self.num_clients) >= self.drop_rate

    def delays(self, epoch):
        """Per-client response delay in seconds (0 for prompt clients)."""
        stragglers = (self._rng(epoch, 1).random(self.num_clients)
                      < self.straggler_rate)
        return np.where(stragglers, float(self.straggler_delay), 0.0)

    def participation(self, epoch, *, straggler_timeout=None):
        """The epoch's ``(mask, wait_seconds)`` under the straggler policy.

        ``straggler_timeout=None`` is the WAIT policy: every available
        client participates and the host stalls for the slowest
        straggler's delay. A finite timeout is DROP-AND-MASK: clients
        slower than the timeout are masked out with the dropouts and the
        host waits at most the timeout (only spent if someone straggles
        within it).
        """
        mask = self.available(epoch)
        delays = np.where(mask, self.delays(epoch), 0.0)
        if straggler_timeout is None:
            return mask, float(delays.max(initial=0.0))
        mask = mask & (delays <= float(straggler_timeout))
        waited = np.where(mask, delays, 0.0)
        return mask, float(waited.max(initial=0.0))

    def should_kill(self, process_id, epoch):
        return (self.kill_process is not None
                and process_id == self.kill_process
                and epoch == self.kill_epoch)

    def maybe_kill(self, process_id, epoch):
        """SIGKILL the calling process if the schedule says so — no Python
        teardown, no atexit, no flushing: the process is simply gone, like
        a powered-off IoT gateway."""
        if self.should_kill(process_id, epoch):
            os.kill(os.getpid(), signal.SIGKILL)


def ensure_group_survivor(mask, num_clients, *, alpha=1.0):
    """Graceful degradation of a random dropout draw: revive the
    lowest-index client of any flush group the draw emptied, so the mask
    always satisfies ``check_participation``'s >= 1-survivor-per-group
    invariant. Returns ``(mask, revived_client_indices)`` — the launcher
    logs the revivals instead of crashing the round."""
    mask = np.asarray(mask, dtype=bool).copy()
    if mask.shape != (num_clients,):
        raise ValueError(
            f"mask must have shape ({num_clients},); got {mask.shape}")
    revived, start = [], 0
    for c in flush_group_sizes(num_clients, alpha):
        if not mask[start:start + c].any():
            mask[start] = True
            revived.append(start)
        start += c
    return mask, revived
