"""The program's own spans and counters, read out of a traced window.

The port records spans through PyTorch's profiler (``repro_torch.trace``):
in the full pass they are rows of the trace (category ``cpu_op``) on the
same clock as the CUDA activity, and ``tracing.Trace.ops`` holds them. It
keeps counters in ``repro_torch.trace.COUNTERS``. Here kernels are
charged to spans:

* a kernel launched inside a span: the span is open on the launch call's
  thread at the call's time;
* a backward kernel: its launch call lies inside an
  ``autograd::engine::evaluate_function: <node>`` row, whose ``Sequence
  number`` is that of the forward operator that made the node, so the
  kernel goes to the span open around that operator.

A checkout whose program has no spans or counters gives nothing to read:
every function here returns ``None`` then, and the readers leave their
metric out.
"""
from __future__ import annotations

import sys
from collections import defaultdict

from bench import tracing

EVALUATE = "autograd::engine::evaluate_function: "
SEQ = "Sequence number"


def counters():
    """The program's ``COUNTERS``, or ``None`` where the program has none
    (the run's own ``repro_torch.trace`` module, never imported here)."""
    return getattr(sys.modules.get("repro_torch.trace"), "COUNTERS", None)


def has_span(trace, prefixes):
    """Whether the window holds a span whose name starts with one of
    ``prefixes``."""
    return any(e["name"].startswith(prefixes) for e in trace.ops)


def kernel_stacks(trace):
    """For each kernel of the window, the rows open around its launch call
    on that call's thread, outermost first (indices into ``trace.ops``);
    empty where no launch call is found. Kept on the trace once made."""
    if "_kernel_stacks" in trace.__dict__:
        return trace._kernel_stacks
    by_corr = {}
    for e in trace.launch_calls:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            by_corr[c] = e
    want = defaultdict(list)                # tid -> [(ts, kernel index)]
    for k, e in enumerate(trace.kernels):
        call = by_corr.get(e.get("args", {}).get("correlation"))
        if call is not None:
            want[call["tid"]].append((float(call["ts"]), k))
    ops = trace._ops_by_tid()
    out = [[] for _ in trace.kernels]
    for tid, pts in want.items():
        pts.sort()
        stacks = tracing._stacks(ops.get(tid, []), [t for t, _ in pts])
        for (_, k), st in zip(pts, stacks):
            out[k] = st
    trace._kernel_stacks = out
    return out


def forward_stacks(trace):
    """``Sequence number`` -> the rows open around the forward operator
    that made the autograd node of that number. Operators that make no
    node take the number the next node will have, so the last forward
    row that carries a number, in time, is the one that made it; rows
    inside a backward's ``evaluate_function`` are not forward rows. Kept
    on the trace once made."""
    if "_forward_stacks" in trace.__dict__:
        return trace._forward_stacks
    out = {}
    for rows in trace._ops_by_tid().values():
        seq = [(s, i) for s, _, i in rows
               if SEQ in trace.ops[i].get("args", {})]
        for (_, i), st in zip(seq, tracing._stacks(rows,
                                                   [s for s, _ in seq])):
            if not any(trace.ops[j]["name"].startswith(EVALUATE)
                       for j in st):
                out[trace.ops[i]["args"][SEQ]] = st
    trace._forward_stacks = out
    return out


def _innermost(trace, stack, prefixes):
    for i in reversed(stack):
        if trace.ops[i]["name"].startswith(prefixes):
            return trace.ops[i]["name"]
    return None


def charged_spans(trace, prefixes):
    """For each kernel of the window, the innermost span named with one of
    ``prefixes`` that it is charged to (on its launch call's stack, else
    through its backward node's forward operator), or ``None``."""
    out = []
    for st in kernel_stacks(trace):
        name = _innermost(trace, st, prefixes)
        if name is None:
            nodes = [i for i in st
                     if trace.ops[i]["name"].startswith(EVALUATE)]
            if nodes:
                fwd = forward_stacks(trace)
                seq = trace.ops[nodes[-1]].get("args", {}).get(SEQ)
                name = _innermost(trace, fwd.get(seq, []), prefixes)
        out.append(name)
    return out


def device_pct(trace, prefixes):
    """Percent of the window's kernel time charged to spans named with one
    of ``prefixes``; ``None`` where the window holds no such span."""
    total = sum(float(e["dur"]) for e in trace.kernels)
    if total <= 0 or not has_span(trace, prefixes):
        return None
    mine = sum(float(e["dur"]) for e, name in
               zip(trace.kernels, charged_spans(trace, prefixes))
               if name is not None)
    return 100.0 * mine / total


def launches_under(trace, prefixes):
    """Kernels of the window whose launch call has a span named with one
    of ``prefixes`` on its stack, on any thread, over the window's steps;
    ``None`` where the window holds no such span."""
    if not trace.steps or not has_span(trace, prefixes):
        return None
    n = sum(1 for st in kernel_stacks(trace)
            if any(trace.ops[i]["name"].startswith(prefixes) for i in st))
    return n / trace.steps
