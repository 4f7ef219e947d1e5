"""Multi-process runtime wiring: joining the process group with retries.

One process per host (or per card): ``initialize`` joins the default
``torch.distributed`` process group, after which the sharded epochs run
unchanged (``engine_dist.init_data_group`` finds the group up and makes
its placement; ``engine_dist.make_pod_layout`` lays the ranks out as pods,
so the JAX package's ``make_pod_mesh`` has no twin here). Every process
runs the same program over the same replicated host inputs (generators
seeded alike, fault plans drawn from their seed).

Typical worker:

    from repro_torch.launch import multihost
    multihost.initialize("10.0.0.1:8476", num_processes=2, process_id=pid)
    group = ED.init_data_group("cpu", pods=2)
    st = ED.shard_dcml_state(st0, group)

The JAX package's ``local_devices`` (a forced CPU device count) and
``cpu_collectives`` (its CPU collective backend) have no meaning here: a
rank is one process on one device, and the backend is gloo on the CPU
and NCCL on the card. Nothing here touches the process group at import
time.
"""
from __future__ import annotations

import datetime
import logging

import numpy as np
import torch

from repro_torch.core.retry import retry_call

logger = logging.getLogger(__name__)


def initialize(coordinator_address, num_processes, process_id, *,
               backend=None, timeout_s=300, connect_attempts=5,
               connect_base_delay=0.5, connect_max_delay=8.0, sleep=None):
    """Join the default process group as rank ``process_id`` of
    ``num_processes``.

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous on rank 0's
    store) or any ``init_method`` URL, such as ``file:///path`` for a
    ``FileStore`` on a shared file system. ``backend`` defaults to NCCL
    when CUDA is present, else gloo; ``timeout_s`` bounds every
    collective of the group.

    The join races the coordinator's listen socket (and, on a real fleet,
    any transient fabric fault), so it runs under ``core.retry.retry_call``:
    ``connect_attempts`` tries with jittered exponential backoff between
    ``connect_base_delay`` and ``connect_max_delay`` seconds, the jitter
    seeded by ``process_id`` so simultaneous joiners decorrelate
    deterministically. A failed attempt destroys any half-made group
    first. After the budget a ``core.retry.RetryError`` names the join,
    the budget, and the last underlying error. ``sleep`` injects a test
    clock."""
    import torch.distributed as dist
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    kw = {} if sleep is None else {"sleep": sleep}

    def _join():
        try:
            dist.init_process_group(
                backend, init_method=init_method, world_size=num_processes,
                rank=process_id,
                timeout=datetime.timedelta(seconds=timeout_s))
        except Exception:
            # a failed connect can leave the default group half-set, which
            # would turn every retry into "already initialized": reset it
            # so the next attempt starts clean
            if dist.is_initialized():
                dist.destroy_process_group()
            raise

    retry_call(
        _join,
        attempts=connect_attempts, base_delay=connect_base_delay,
        max_delay=connect_max_delay, seed=process_id,
        retry_on=(RuntimeError, ConnectionError, TimeoutError),
        describe=(f"torch.distributed join (process {process_id}/"
                  f"{num_processes} -> {coordinator_address})"), **kw)
    logger.info("joined process group: process %d/%d at %s", process_id,
                num_processes, coordinator_address)


def host_value(x, *, sharded=False):
    """``x`` as numpy on every rank. ``sharded=True`` means ``x`` is this
    rank's block of a tensor split over the ranks along its first axis
    (as ``engine_dist.shard_dcml_state`` splits the clients): the blocks
    are all-gathered in rank order (a collective: every rank calls it).
    bf16 widens to f32 (numpy has no bf16)."""
    import torch.distributed as dist
    x = x.detach()
    if sharded and dist.is_initialized() and dist.get_world_size() > 1:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        x = torch.cat(parts)
    x = x.cpu()
    return np.asarray((x.float() if x.dtype == torch.bfloat16 else x)
                      .numpy())
