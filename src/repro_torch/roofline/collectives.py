"""Collective traffic for the roofline, from a traced step.

The counterpart of the JAX package's ``roofline/hlo.py``, which parses
the compiled HLO text for collectives: PyTorch has no HLO text, so the
dry run (``launch/dryrun.py``) records each ``_c10d_functional``
collective that DTensor issues during a traced step, with the bytes of
its result on one device, and :func:`collective_bytes` sums them under
XLA's op names.

Traffic model per op type (ring algorithms, n = participants; the result
bytes times a traffic factor), as the JAX package's:
  all-gather         result is the gathered buffer; traffic/device ~
                     (n-1)/n of the result -> factor 1.0 (upper bound)
  all-reduce         ~2x the buffer (reduce-scatter + all-gather phases)
  reduce-scatter     only the result is seen; factor 1.0 of the result
                     (a lower bound)
  all-to-all         each device sends (n-1)/n of its shard -> factor 1.0
  collective-permute ~1.0
"""
from __future__ import annotations

_COLL_FACTOR = {
    "all-gather": 1.0,
    "all-reduce": 2.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# c10d functional op (its name in torch.ops._c10d_functional) -> XLA's
XLA_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def xla_name(op_name):
    """XLA's name of a ``_c10d_functional`` op (its bare name, such as
    ``all_gather_into_tensor``), or None for what is not a collective
    (``wait_tensor``) or has no XLA name (``broadcast``: recorded under
    its own name by the tracer's caller if wanted)."""
    return XLA_NAMES.get(op_name)


def collective_bytes(records):
    """``records``: ``(xla op name, result bytes on one device)`` pairs.
    Returns ``{op: {"count": int, "bytes": int, "traffic_bytes": int}}``,
    as the JAX package's ``collective_bytes_from_text``: ``bytes`` is the
    summed result size on one device; ``traffic_bytes`` applies the op's
    traffic factor."""
    out = {}
    for op, b in records:
        d = out.setdefault(op, {"count": 0, "bytes": 0, "traffic_bytes": 0})
        d["count"] += 1
        d["bytes"] += int(b)
        d["traffic_bytes"] += int(b * _COLL_FACTOR.get(op, 1.0))
    return out
