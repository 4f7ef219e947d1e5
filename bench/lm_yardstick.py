"""The split-LM cells' fixed arithmetic: the model FLOPs of an SFPL step
of an afmoe model and the FLOPs of its attention cores and expert
products, as pure functions of the configuration (Hugging Face's keys,
``bench/configs/*.json``), the traffic and the rows the held experts
ran, which ``forward_held_rows`` reads from the traced step.

A multiply-add is two FLOPs. A token's forward:

* attention projections: q, the output gate and o of ``d x heads *
  head_dim`` each, k and v of ``d x kv_heads * head_dim``;
* the attention core: ``4 * heads * head_dim`` a key attended (q.k and
  p.v), the keys those the causal mask and, on a windowed layer, the
  window let through (``keys_attended``);
* the dense layers' SwiGLU: three products of ``d x intermediate_size``;
* an MoE layer: the router, ``d x router_experts``; the shared experts'
  SwiGLU; and the held experts' SwiGLU over the rows routed to them, as
  the traced step's forward ran them (its ``aten::_grouped_mm`` rows'
  shapes: three products of the same rows a call). Routing moves as the
  router trains, so the run's average (``COUNTERS["moe"]``) would not
  be the traced step's;
* the head, ``d x vocab_size``.

A training step is the forward times three (a product's backward is two
of its forward), without the recompute: the model FLOPs. The kernels'
own work counts the recompute: the program recomputes every layer
(``remat``), so its expert products run their forward twice and their
backward once (four forwards), and its attention cores their forward
twice and their backward once, counted as 2.5 forwards (FlashAttention's
backward recomputes the scores: five products to the forward's two).
"""
from __future__ import annotations

from bench import yardstick as Y

PEAK = Y.PEAK_FLOPS["bfloat16"]
ATTN_BWD = 2.5
EXPERT_RUNS = 4.0          # forward, recompute, and a backward of two
ATTN_RUNS = 2.0 + ATTN_BWD  # forward, recompute, backward


def is_full(config, layer):
    return (layer + 1) % config["global_attn_every_n_layers"] == 0


def keys_attended(seq, window=None):
    """Keys summed over the ``seq`` queries of one sequence: ``i + 1`` for
    query ``i`` under the causal mask, at most ``window``."""
    if window is None or window >= seq:
        return seq * (seq + 1) // 2
    return window * (window + 1) // 2 + (seq - window) * window


def attn_core_flops(config, traffic):
    """The attention cores' forward FLOPs of one step, every layer,
    windows counted."""
    c = config
    per_key = 4 * c["num_attention_heads"] * c["head_dim"]
    seq = traffic["seq_len"]
    keys = sum(keys_attended(seq, None if is_full(c, i)
                             else c["sliding_window"])
               for i in range(c["num_hidden_layers"]))
    return traffic["clients"] * per_key * keys


def expert_flops_per_row(config):
    """One routed row through one expert's SwiGLU (three products)."""
    return 3 * 2 * config["hidden_size"] * config["moe_intermediate_size"]


def moe_layers(config):
    return config["num_hidden_layers"] - config["num_dense_layers"]


def forward_held_rows(trace):
    """A MoE layer's rows through its held experts in the traced step's
    forward, on average over the layers: the rows of the forward's
    ``aten::_grouped_mm`` calls (none inside a backward's
    ``evaluate_function``: the recompute and the backward run the same
    rows again), a third of them (a call's three products share its
    rows), over the steps and the MoE layers; ``None`` where the trace
    records none."""
    from bench import spans, tracing
    rows = 0
    for tid_rows in trace._ops_by_tid().values():
        pts = [(s, i) for s, _, i in tid_rows
               if trace.ops[i]["name"] == "aten::_grouped_mm"]
        for (_, i), st in zip(pts, tracing._stacks(tid_rows,
                                                   [s for s, _ in pts])):
            if not any(trace.ops[j]["name"].startswith(spans.EVALUATE)
                       for j in st):
                rows += trace.ops[i]["args"]["Input Dims"][0][0]
    if not rows or not trace.steps:
        return None
    return rows / 3 / trace.steps / moe_layers(trace.cell.config)


def step_model_flops(config, traffic, held_rows):
    """Model FLOPs of one SFPL step (forward times three, no recompute),
    ``held_rows`` a MoE layer's rows through its held experts."""
    c = config
    d, hd = c["hidden_size"], c["head_dim"]
    q = c["num_attention_heads"] * hd
    kv = c["num_key_value_heads"] * hd
    tokens = traffic["clients"] * traffic["seq_len"]
    proj = 2 * d * (3 * q + 2 * kv) * c["num_hidden_layers"]
    dense = 3 * 2 * d * c["intermediate_size"] * c["num_dense_layers"]
    shared = c["num_shared_experts"] * expert_flops_per_row(c)
    router = 2 * d * c["deployment"]["router_experts"]
    moe = (router + shared) * moe_layers(c)
    head = 2 * d * c["vocab_size"]
    per_token = proj + dense + moe + head
    routed = held_rows * expert_flops_per_row(c) * moe_layers(c)
    return 3 * (tokens * per_token + attn_core_flops(c, traffic) + routed)


def expert_kernel_flops(config, held_rows):
    """The held experts' products that the kernels run in one step
    (forward, recompute and backward)."""
    return EXPERT_RUNS * held_rows * expert_flops_per_row(config) \
        * moe_layers(config)


def attn_kernel_flops(config, traffic):
    """The attention cores' FLOPs that the kernels run in one step
    (forward, recompute and a backward of 2.5 forwards)."""
    return ATTN_RUNS * attn_core_flops(config, traffic)


def charged_seconds(trace, span):
    """Device seconds of the window's kernels charged to ``span`` (its
    forward kernels by their launch, its backward kernels through their
    forward operator: ``bench/spans.py``); ``None`` where the window
    holds no such span."""
    from bench import spans
    if not spans.has_span(trace, (span,)):
        return None
    return sum(float(e["dur"]) for e, name in
               zip(trace.kernels, spans.charged_spans(trace, (span,)))
               if name == span) * 1e-6
