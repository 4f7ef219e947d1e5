"""Spans and counters of the port, recorded through PyTorch's profiler.

``span(name)`` marks a region of the host's work. Under ``torch.profiler``
with CPU activity it records one row (category ``cpu_op``) into the same
trace, on the same clock, as the operators and the CUDA activity that the
region launches; spans nest as the regions do. With no profiler running
it costs one check of the profiler's flag and records nothing, so the
profiler being on is the only switch. A span launches no kernel,
synchronises nothing and touches no tensor. Under a profiler of the CUDA
activity alone, PyTorch registers no recorder on the host, so a span
enters an inactive record and leaves no row.

The spans of the single-device SFPL step (``core/round.py``,
``core/collector`` strategies, ``optim/sgd.py``, ``nn/norm.py``):

* ``sfpl.round``: one call of ``sfpl_round``, an epoch;
* ``sfpl.step``: one step, every phase below nested in it;
* ``sfpl.perm``: the step's permutation, its route plans, the label
  permute and the participation masks;
* ``sfpl.client_fwd``: the no-grad client forward (the streamed forward
  and exchange on the pipelined collector);
* ``collector.permute``: one ``permute`` call of the collector;
* ``sfpl.server_fwd``: the server's forward and loss;
* ``sfpl.server_bwd``: its backward (and ``route_back`` when streamed)
  and the gradients' sum over ranks;
* ``sfpl.client_upd``: the clients' re-forward, backward, local step and
  participation gate;
* ``optim.sgd`` / ``optim.adamw``: one optimizer update;
* ``sfpl.fedavg``: FedAvg and the BN-state aggregation of the epoch;
* ``bn.stats``: a BatchNorm's batch moments (training, or CMSD
  inference) and its running update (inside ``bn.act`` where the
  training op runs them);
* ``bn.act``: a BatchNorm's normalise, affine and ReLU (K2 or plain),
  and with the training op, the op itself, whose backward it is charged.

``collector.permute`` also marks the split LM's shuffle at the cut
(``models/common.py::take_rows`` through K1 on the card). The spans of
the transformer family's layers (``nn/moe.py``, ``nn/attention.py``):

* ``attn.core``: the attention core of every path (``xla``, ``kernel``,
  ``flex``): the scores, the softmax and the values' sum, without the
  projections;
* ``moe.route``: the dropless MoE's router, its top-k, the weights'
  norm and scale, and the per-expert counts;
* ``moe.dispatch``: the sort of the held token-slots by expert, the
  host's read of their count, and the gather of their rows;
* ``moe.experts``: the held experts' grouped products;
* ``moe.combine``: the weighted scatter back by token and the shared
  expert's add.

``COUNTERS`` is the one registry of counters, groups of named integers
that only grow until ``reset()``:

* ``COUNTERS["launches"]``: launches of each kernel family, filled by
  ``repro_torch.kernels``, whose ``LAUNCHES`` is the same dict;
* ``COUNTERS["bytes"]``: bytes (every operand byte read once, every
  output byte written once) of the SFPL step's kernels K1, K2, K3f and
  K3b and the BatchNorm training op's ``bn_moments`` and ``bn_grad``,
  counted beside their launches (``kernels.BYTES``);
* ``COUNTERS["sfpl"]``: ``steps`` of ``sfpl_round``, and
  ``permuted_bytes``, the float payload bytes the collector gathered
  forward (the backward de-shuffle moves as many again);
* ``COUNTERS["moe"]``: the dropless MoE's forward calls, recompute
  included (a layer under remat counts twice a step): ``calls``;
  ``tokens``, the tokens they routed; ``held_rows``, the token-slots
  routed to held experts, the rows the grouped products ran. Their
  ratio against ``tokens * top_k * held / experts`` is the held
  experts' load against an even share.
"""
from __future__ import annotations

import contextlib
import functools

from torch._C._profiler import _RecordFunctionFast as _Record
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()

COUNTERS = {"launches": {}, "bytes": {},
            "sfpl": {"steps": 0, "permuted_bytes": 0},
            "moe": {"calls": 0, "tokens": 0, "held_rows": 0}}


def span(name):
    """A context manager that records ``name`` as a profiler row around
    its block while a profiler runs, and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return _Record(name)
    return _OFF


def spanned(name):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def reset():
    """Zero every counter of every group."""
    for group in COUNTERS.values():
        for key in group:
            group[key] = 0
