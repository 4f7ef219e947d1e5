"""Mixture-of-experts layers: llama4's top-1 with capacity dropping
(``moe_apply``) and afmoe's dropless sigmoid top-k over the experts this
device holds (``moe_dropless_apply``, below).

The JAX package's dispatch, kept step for step so that the same tokens are
routed, kept and dropped. Tokens are routed locally per data-parallel
group: the token axis is reshaped to (dp_groups, T_local) and every sort,
rank and gather runs along the local axis:

  1. sort tokens by expert id (a stable sort: which tokens past capacity
     are dropped depends on the order within an expert's run)
  2. per-(group, expert) counts -> exclusive-cumsum offsets
  3. dispatch = a gather of the sorted tokens into a dense (G, E, C, d)
     buffer (C = local capacity)
  4. the experts' SwiGLU as batched products over the expert axis
  5. combine = a gather back by (expert, rank), unsort, gate-scale.

Llama-4 details: top-1 router in f32, sigmoid gate on the routed expert's
output, an always-on shared expert. Tokens past an expert's capacity get
no routed output (the shared expert still sees them).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.sharding.dtensor import (apply_spec, dp_spec, fsdp_gather,
                                          local_region)
from repro_torch.nn.init import lecun_normal, normal_init
from repro_torch.nn.mlp import ACTS, mlp_apply, mlp_init
from repro_torch.sharding.rules import MOE_EP_DATA
from repro_torch.trace import COUNTERS, span


def moe_init(gen, d_model, d_ff, num_experts, *, shared_expert=True,
             dtype=torch.float32):
    """Router (f32 whatever ``dtype``), the experts' stacked SwiGLU
    weights ``wi``, ``wg`` (E, d, f) and ``wo`` (E, f, d), and the shared
    expert."""
    p = {
        "router": {"w": normal_init(gen, (d_model, num_experts),
                                    stddev=0.02, dtype=torch.float32)},
        "wi": lecun_normal(gen, (num_experts, d_model, d_ff), dtype=dtype,
                           in_axis=1, out_axis=2),
        "wg": lecun_normal(gen, (num_experts, d_model, d_ff), dtype=dtype,
                           in_axis=1, out_axis=2),
        "wo": lecun_normal(gen, (num_experts, d_ff, d_model), dtype=dtype,
                           in_axis=1, out_axis=2),
    }
    if shared_expert:
        p["shared"] = mlp_init(gen, d_model, d_ff, gated=True, dtype=dtype)
    return p


def _constrain(x, mesh_axes, spec_template):
    """Best-effort sharding constraint: each template entry (None, an axis
    name or a tuple of names) kept where its axes divide the dim. The
    identity without ``mesh_axes`` or on a plain tensor."""
    if not mesh_axes:
        return x
    sizes = dict(mesh_axes)
    spec = []
    for tok, dim in zip(spec_template, x.shape):
        if tok is None:
            spec.append(None)
            continue
        axes = tok if isinstance(tok, tuple) else (tok,)
        prod = 1
        for a in axes:
            prod *= sizes.get(a, 1)
        spec.append(tok if dim % prod == 0 and dim >= prod else None)
    return apply_spec(x, mesh_axes, spec)


def _rank_in_sorted_groups(sorted_eid):
    """sorted_eid: (G, T) ascending. The rank of each element within its
    run of equal ids."""
    T = sorted_eid.shape[-1]
    idx = torch.arange(T, device=sorted_eid.device)
    new_run = torch.cat(
        [torch.ones_like(sorted_eid[..., :1], dtype=torch.bool),
         sorted_eid[..., 1:] != sorted_eid[..., :-1]], dim=-1)
    run_start = torch.cummax(torch.where(new_run, idx, 0), dim=-1).values
    return idx - run_start


def capacity(tokens, num_experts, capacity_factor):
    """Slots an expert holds for ``tokens`` local tokens. Python's
    ``round`` (half to even), as the JAX package rounds: T 8, E 4 and
    factor 1.25 give 2."""
    return int(max(1, round(tokens / num_experts * capacity_factor)))


def _router(xt, w, gate):
    """The top-1 router in f32: (logits (G, Tl, E), expert id, gate)."""
    logits = xt.float() @ w.float()                          # (G, Tl, E)
    expert_id = logits.argmax(dim=-1)                         # first max
    # amax: a tie shares the gradient as jnp.max's does
    if gate == "sigmoid":        # llama4: sigmoid of the chosen logit
        gate_val = torch.sigmoid(logits.amax(dim=-1))
    else:
        gate_val = torch.softmax(logits, dim=-1).amax(dim=-1)
    return logits, expert_id, gate_val


def _dispatch(xt, expert_id, E, C):
    """Steps 1-3 on one device's groups: the stable sort by expert and
    the gather-only dispatch into (G, E, C, d) slots. Returns (buf,
    sort_idx, sorted_eid)."""
    G, Tl, d = xt.shape
    # 1. local sort by expert
    sort_idx = torch.argsort(expert_id, dim=-1, stable=True)  # (G, Tl)
    sorted_eid = expert_id.gather(-1, sort_idx)
    x_sorted = torch.take_along_dim(xt, sort_idx[..., None], dim=1)

    # 2. per-expert counts -> offsets into the sorted order
    counts = torch.zeros((G, E), dtype=torch.long, device=xt.device)
    counts.scatter_add_(1, expert_id, torch.ones_like(expert_id))
    offsets = torch.cumsum(counts, dim=-1) - counts           # exclusive

    # 3. gather-only dispatch into (G, E, C, d)
    pos = torch.arange(C, device=xt.device)
    gather_idx = (offsets[..., None] + pos).clamp(0, Tl - 1)  # (G, E, C)
    valid = pos < torch.clamp_max(counts, C)[..., None]
    buf = torch.take_along_dim(
        x_sorted, gather_idx.reshape(G, E * C)[..., None], dim=1)
    buf = buf.reshape(G, E, C, d) * valid[..., None].to(xt.dtype)
    return buf, sort_idx, sorted_eid


def _combine(out, gate_val, sort_idx, sorted_eid, C):
    """Step 5 on one device's groups: the token at sorted position t sits
    at (expert, rank); unsort and gate-scale. Returns (y (G, Tl, d), keep
    (G, Tl))."""
    G, E, _, d = out.shape
    Tl = sort_idx.shape[-1]
    rank = _rank_in_sorted_groups(sorted_eid)                 # (G, Tl)
    keep = rank < C
    comb_idx = sorted_eid * C + torch.clamp_max(rank, C - 1)
    y_sorted = torch.take_along_dim(out.reshape(G, E * C, d),
                                    comb_idx[..., None], dim=1)
    y_sorted = y_sorted * keep[..., None].to(out.dtype)
    inv = torch.empty_like(sort_idx).scatter_(
        -1, sort_idx, torch.arange(Tl, device=out.device).expand(G, Tl))
    y_routed = torch.take_along_dim(y_sorted, inv[..., None], dim=1)
    return y_routed * gate_val[..., None].to(y_routed.dtype), keep


def _experts(buf, params, act, mesh_axes, dp_tok):
    """Step 4, the experts' SwiGLU batched over the expert axis, with the
    JAX package's expert-parallel layouts under ``mesh_axes``."""
    wi, wg, wo = (fsdp_gather(params[k]) for k in ("wi", "wg", "wo"))
    if MOE_EP_DATA and mesh_axes:
        # all-to-all layout: (G, E, C, d) -> (E, G, C, d) with the expert
        # dim on the data axis
        buf_t = _constrain(buf.transpose(0, 1), mesh_axes,
                           (dp_tok, None, None, None))
        h = torch.einsum("egcd,edf->egcf", buf_t, wi)
        g = torch.einsum("egcd,edf->egcf", buf_t, wg)
        h = _constrain(ACTS[act](g) * h, mesh_axes,
                       (dp_tok, None, None, "model"))
        out_t = torch.einsum("egcf,efd->egcd", h, wo)
        out_t = _constrain(out_t, mesh_axes, (dp_tok, None, None, None))
        return _constrain(out_t.transpose(0, 1), mesh_axes,
                          (dp_tok, "model", None, None))
    h = torch.einsum("gecd,edf->gecf", buf, wi)
    g = torch.einsum("gecd,edf->gecf", buf, wg)
    h = ACTS[act](g) * h
    out = torch.einsum("gecf,efd->gecd", h, wo)
    # low-comm combine: the feature dim (not the expert dim) over "model",
    # so the combine gathers stay shard-local
    return _constrain(out, mesh_axes, (dp_tok, None, None, "model"))


def moe_apply(params, x, *, num_experts, capacity_factor=1.25, act="silu",
              gate="sigmoid", dp_groups=1, mesh_axes=None):
    """x: (B, S, d). Returns ``(y, aux)``: y (B, S, d) in x's dtype; aux
    the router logits (T, E) f32, each token's expert id (T,) and the
    fraction of tokens dropped past capacity.

    Under ``mesh_axes`` with DTensor inputs the groups lie over the dp
    axes; the routing (steps 1-3) and the combine (step 5) run on each
    device's own groups (``local_region``); the router and the experts'
    products run on the DTensors, with the JAX package's constraints."""
    B, S, d = x.shape
    E = num_experts
    T = B * S
    G = dp_groups if T % dp_groups == 0 else 1
    Tl = T // G
    C = capacity(Tl, E, capacity_factor)

    dp_tok = None
    if mesh_axes:
        dp_tok = tuple(a for a, _ in mesh_axes if a != "model") or None
    gdp = dp_spec(mesh_axes, G) if mesh_axes else None

    xt = _constrain(x.reshape(G, Tl, d), mesh_axes, (dp_tok, None, "model"))
    logits, expert_id, gate_val = _router(xt, params["router"]["w"], gate)
    buf, sort_idx, sorted_eid = local_region(
        lambda xt_, eid: _dispatch(xt_, eid, E, C), mesh_axes,
        [(gdp, None, None), (gdp, None)],
        [(gdp, None, None, None), (gdp, None), (gdp, None)],
    )(xt, expert_id)
    buf = _constrain(buf, mesh_axes, (dp_tok, "model", None, None))

    out = _experts(buf, params, act, mesh_axes, dp_tok)

    y_routed, keep = local_region(
        lambda o, g_, si, se: _combine(o, g_, si, se, C), mesh_axes,
        [(gdp, None, None, None), (gdp, None), (gdp, None), (gdp, None)],
        [(gdp, None, None), (gdp, None)],
    )(out, gate_val, sort_idx, sorted_eid)
    y = y_routed.reshape(T, d)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], x.reshape(T, d), act=act)
    y = y.reshape(B, S, d).to(x.dtype)
    aux = {
        "router_logits": logits.reshape(T, E),
        "expert_id": expert_id.reshape(T),
        "dropped_frac": 1.0 - keep.float().mean(),
    }
    return y, aux


def router_load_balance_loss(router_logits, expert_id, num_experts):
    """Switch-transformer load balance loss: ``E * sum_e f_e * p_e``."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    p_e = probs.mean(dim=0)                                   # (E,)
    f_e = F.one_hot(expert_id.long(), num_experts).float().mean(dim=0)
    return num_experts * torch.sum(f_e * p_e)


# --------------------------------------------------------------------------
# dropless sigmoid top-k over the held experts (afmoe; TorchTitan's
# token-choice MoE with ``score_func="sigmoid"``)
#
#   s = sigmoid(h @ w_router)                  f32, over all E experts
#   I = top_k(s + b)                           b: the expert bias, no grad
#   w = s_I / (sum s_I + 1e-20) * route_scale
#   y = sum_{j in I, j held} w_j * SwiGLU_j(h) + SwiGLU_shared(h)
#
# Expert parallelism's share: the layer holds the weights of the experts
# ``[offset, offset + count)`` and computes only the token-slots routed to
# them; what the other experts would add is left out (their devices add
# it), and so is the router's gradient, which would need them: the
# weights are taken as values. A gradient from the held experts alone
# would drive the router away from them (their slots alone add an
# output), and their load with it. Steps: route; sort the held
# token-slots by expert (one stable sort of all slots, the others keyed
# past the end) and gather their rows; the experts' SwiGLU as grouped
# products over per-expert row offsets kept on the device; scale by w and
# scatter-add back by token. The held rows' count, which sizes the
# buffer, is the call's one read of the device by the host.

_ROUTES = []


class RoutingRecord:
    """What the dropless MoE calls inside ``record_routing`` routed, in
    call order: ``counts``, each call's token-slots per expert (E,)
    int64; with ``keep_choices``, ``choices``, each call's experts per
    token (T, k)."""

    def __init__(self, keep_choices=False):
        self.keep_choices = keep_choices
        self.counts, self.choices = [], []


@contextlib.contextmanager
def record_routing(keep_choices=False):
    """Record the routing of every dropless MoE call made inside the
    block (the forward's calls only, when the backward, and with it any
    recompute, runs after the block)."""
    rec = RoutingRecord(keep_choices)
    _ROUTES.append(rec)
    try:
        yield rec
    finally:
        _ROUTES.remove(rec)


def moe_dropless_init(gen, d_model, d_ff, num_experts, *, held=None,
                      shared_expert=True, dtype=torch.float32):
    """Router (f32, all ``num_experts`` outputs), the expert bias (f32
    zeros, a non-gradient leaf), the held experts' stacked SwiGLU weights
    ``wi``, ``wg`` (E_held, d, f) and ``wo`` (E_held, f, d), and the
    shared expert."""
    n = num_experts if held is None else held[1]
    w = normal_init(gen, (d_model, num_experts), stddev=0.02,
                    dtype=torch.float32)
    p = {"router": {"w": w},
         "expert_bias": torch.zeros(num_experts, dtype=torch.float32,
                                    device=w.device)}
    for k, shape in (("wi", (n, d_model, d_ff)), ("wg", (n, d_model, d_ff)),
                     ("wo", (n, d_ff, d_model))):
        p[k] = lecun_normal(gen, shape, dtype=dtype, in_axis=1, out_axis=2)
    if shared_expert:
        p["shared"] = mlp_init(gen, d_model, d_ff, gated=True, dtype=dtype)
    return p


def route_topk(h, w_router, bias, top_k, *, route_scale=1.0):
    """Sigmoid scores in f32, the top-k experts of ``scores + bias`` and
    their weights, normalised to sum 1 and scaled: ``(idx (T, k),
    weights (T, k) f32)``."""
    scores = torch.sigmoid(h.float() @ w_router.float())
    sel = scores if bias is None else scores + bias.detach().float()
    idx = torch.topk(sel, top_k, dim=-1).indices
    w = scores.gather(-1, idx)
    return idx, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * route_scale


def _grouped_swiglu(xs, wi, wg, wo, counts, offs, act):
    """Each held expert's SwiGLU over its run of rows of ``xs`` (rows
    sorted by expert, ``counts`` a run, ``offs`` their inclusive
    cumsum): grouped products on the card, a loop over the runs on the
    CPU."""
    if xs.is_cuda:
        h = torch._grouped_mm(xs, wi, offs=offs)
        g = torch._grouped_mm(xs, wg, offs=offs)
        return torch._grouped_mm(ACTS[act](g) * h, wo, offs=offs)
    outs = [ACTS[act](x @ wg[e]) * (x @ wi[e]) @ wo[e] for e, x in
            enumerate(torch.split(xs, counts.tolist()))]
    return torch.cat(outs) if outs else xs.new_zeros((0, wo.shape[-1]))


def moe_dropless_apply(params, x, *, num_experts, top_k, held=None,
                       route_scale=1.0, act="silu"):
    """x: (B, S, d). Returns ``(y, aux)``: y (B, S, d) in x's dtype, the
    held experts' weighted outputs plus the shared expert's (where some
    experts are not held, the weights as values: no gradient reaches the
    router); aux the call's token-slots per expert ``counts`` (E,) over
    every expert and each token's experts ``expert_id`` (T, k).

    Counts into ``COUNTERS["moe"]`` (every call, recompute included) and
    into any open ``record_routing``."""
    B, S, d = x.shape
    T, E = B * S, num_experts
    lo, n = (0, E) if held is None else held
    xt = x.reshape(T, d)
    with span("moe.route"):
        idx, w = route_topk(xt, params["router"]["w"],
                            params.get("expert_bias"), top_k,
                            route_scale=route_scale)
        if n < E:
            w = w.detach()
        flat = idx.reshape(-1)
        counts = torch.zeros(E, dtype=torch.int64, device=x.device)
        counts.scatter_add_(0, flat, torch.ones_like(flat))
    with span("moe.dispatch"):
        local = flat - lo
        key = torch.where((local >= 0) & (local < n), local,
                          torch.full_like(local, n))
        order = torch.argsort(key, stable=True)
        held_counts = counts[lo:lo + n]
        rows = int(held_counts.sum())       # the call's one host read
        order = order[:rows]
        tok = order // top_k
        xs = xt.index_select(0, tok)
        offs = torch.cumsum(held_counts, 0).to(torch.int32)
    with span("moe.experts"):
        out = _grouped_swiglu(xs, params["wi"], params["wg"], params["wo"],
                              held_counts, offs, act)
    with span("moe.combine"):
        ws = w.reshape(-1).index_select(0, order)
        y = torch.zeros((T, d), dtype=torch.float32, device=x.device)
        y = y.index_add(0, tok, out.float() * ws[:, None])
        if "shared" in params:
            y = y + mlp_apply(params["shared"], xt, act=act).float()
        y = y.to(x.dtype).reshape(B, S, d)
    c = COUNTERS["moe"]
    c["calls"] += 1
    c["tokens"] += T
    c["held_rows"] += rows
    for rec in _ROUTES:
        rec.counts.append(counts)
        if rec.keep_choices:
            rec.choices.append(idx)
    return y, {"counts": counts, "expert_id": idx}


def expert_bias_step(bias, counts, rate):
    """The aux-loss-free balance step: ``b + rate * sign(mean(c) - c)``,
    ``c`` the step's token-slots per expert (the last dim), the mean over
    the experts."""
    c = counts.float()
    return bias + rate * torch.sign(c.mean(dim=-1, keepdim=True) - c)
