"""Decoder-only transformer family, for training (``loss_fn``, SFPL's
``collector_perm``), prefill and cached decode: the dense GQA
architectures (qwen3-8b and its kin), the MoE ones (llama4-scout and
llama4-maverick: top-1 MoE with a shared expert, iRoPE's 3 local : 1
global attention pattern), the VLM backbone (qwen2-vl-7b: M-RoPE and
stub vision embeddings merged after BOS) and afmoe (trinity-mini: two
leading dense layers, then dropless sigmoid top-8 MoE layers with a
shared expert; 3 windowed RoPE layers : 1 full layer without RoPE; a
sigmoid gate on the attention's output and four RMSNorms a layer).

Layers are grouped into units of ``cfg.group_size`` (the lcm of the
MoE-period and attention-pattern period); per-group parameters are stacked
on a leading ``num_groups`` axis exactly as the JAX package stacks them, so
parameter trees carry across (``repro_torch.convert``). The JAX package's
``lax.scan`` over the groups is a Python loop here. Leading dense layers
(``cfg.num_dense_layers``) are a stack of their own,
``params["dense_layers"]``, run before the groups, one layer a group.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import (TransformerConfig, chunked_lm_loss,
                                       constrain_act, maybe_remat,
                                       stacked_init, take_rows)
from repro_torch.nn.attention import (
    AttnConfig, attention_init, attention_apply, attention_decode,
    init_kv_cache)
from repro_torch.nn.linear import (
    dense_init, dense_apply, embedding_init, embedding_apply,
    embedding_attend)
from repro_torch.nn.mlp import mlp_init, mlp_apply
from repro_torch.nn.moe import (expert_bias_step, moe_apply,
                                moe_dropless_apply, moe_dropless_init,
                                moe_init, router_load_balance_loss)
from repro_torch.nn.norm import rmsnorm_init, rmsnorm_apply
from repro_torch.tree import tree_map, tree_map_with_path


def _attn_cfg(cfg: TransformerConfig, window):
    return AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        qk_norm=cfg.qk_norm, use_bias=cfg.attn_bias,
        rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
        sliding_window=window, impl=cfg.attention_impl,
        use_rope=cfg.global_rope or window is not None,
        out_gate=cfg.attn_out_gate, norm_eps=cfg.norm_eps,
        mesh_axes=cfg.mesh_axes)


# --------------------------------------------------------------------------
# init

def _layer_init(gen, cfg: TransformerConfig, kind):
    dt = cfg.pdtype()
    p = {
        "attn_norm": rmsnorm_init(gen, cfg.d_model, dtype=dt),
        "attn": attention_init(gen, _attn_cfg(cfg, kind["window"]),
                               dtype=dt),
        "mlp_norm": rmsnorm_init(gen, cfg.d_model, dtype=dt),
    }
    if cfg.sandwich_norm:
        p["post_attn_norm"] = rmsnorm_init(gen, cfg.d_model, dtype=dt)
        p["post_mlp_norm"] = rmsnorm_init(gen, cfg.d_model, dtype=dt)
    if kind["moe"] and cfg.moe_routing == "dropless":
        p["moe"] = moe_dropless_init(gen, cfg.d_model, cfg.d_ff,
                                     cfg.num_experts, held=cfg.experts_held,
                                     shared_expert=cfg.moe_shared_expert,
                                     dtype=dt)
    elif kind["moe"]:
        p["moe"] = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.num_experts,
                            shared_expert=cfg.moe_shared_expert, dtype=dt)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff_dense or cfg.d_ff,
                            gated=cfg.act in ("silu", "gelu"), dtype=dt)
    return p


def init(gen, cfg: TransformerConfig):
    """Parameters drawn from ``gen`` on its device (a CUDA generator makes
    them on the card), the layer groups stacked by ``stacked_init``: the
    peak is the model plus one group, and a model of one group is its own
    stacked leaves (a view), with no copy."""
    G = cfg.group_size
    if cfg.num_layers % G:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple of "
                         f"the group size {G}")
    nd = cfg.num_dense_layers
    num_groups = (cfg.num_layers - nd) // G
    dt = cfg.pdtype()
    params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype=dt),
        "final_norm": rmsnorm_init(gen, cfg.d_model, dtype=dt),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       use_bias=False, dtype=dt)

    if nd:
        params["dense_layers"] = stacked_init(
            lambda: {"sub0": _layer_init(gen, cfg, cfg.layer_kind(0))}, nd)
    params["layers"] = stacked_init(
        lambda: {f"sub{p}": _layer_init(gen, cfg, cfg.layer_kind(nd + p))
                 for p in range(G)}, num_groups)
    return params


def units(cfg: TransformerConfig):
    """The model's units in order, each ``(stack, index, first layer)``:
    the leading dense layers, then the groups. SFPL's ``cut_groups``
    counts units."""
    nd, G = cfg.num_dense_layers, cfg.group_size
    return ([("dense_layers", i, i) for i in range(nd)]
            + [("layers", g, nd + g * G)
               for g in range((cfg.num_layers - nd) // G)])


# --------------------------------------------------------------------------
# forward

def cast_for_compute(tree, cfg: TransformerConfig):
    """Cast float params to the compute dtype (router weights stay f32)."""
    cd = cfg.cdtype()

    def leafcast(path, a):
        if "router" in path or "expert_bias" in path or \
                not a.is_floating_point():
            return a
        return a.to(cd)
    return tree_map_with_path(leafcast, tree)


def _layer(params, g, p, stack="layers"):
    """Layer ``p`` of group ``g`` of ``stack``: views into the stacked
    leaves."""
    return tree_map(lambda a: a[g], params[stack][f"sub{p}"])


def _ffn(lp, h, cfg: TransformerConfig, kind):
    """The layer's MLP or MoE on ``h``: (y, the MoE's aux dict or None)."""
    if not kind["moe"]:
        return mlp_apply(lp["mlp"], h, act=cfg.act), None
    if cfg.moe_routing == "dropless":
        y, _ = moe_dropless_apply(
            lp["moe"], h, num_experts=cfg.num_experts, top_k=cfg.moe_top_k,
            held=cfg.experts_held, route_scale=cfg.route_scale, act=cfg.act)
        return y, None
    dp_groups = 1
    for a, n in cfg.mesh_axes or ():
        if a != "model":
            dp_groups *= n
    return moe_apply(lp["moe"], h, num_experts=cfg.num_experts,
                     capacity_factor=cfg.capacity_factor, act=cfg.act,
                     dp_groups=dp_groups, mesh_axes=cfg.mesh_axes)


def _layer_apply(lp, x, cfg: TransformerConfig, kind, positions, training):
    """One layer: ``(x, aux_loss)``, the router's load-balance loss of an
    MoE layer in training when ``cfg.router_aux_coef`` is set, else 0."""
    lp = cast_for_compute(lp, cfg)
    norm = lambda name, v: rmsnorm_apply(lp[name], v, eps=cfg.norm_eps,
                                         scale_offset=cfg.norm_scale_offset)
    o = attention_apply(lp["attn"], norm("attn_norm", x),
                        _attn_cfg(cfg, kind["window"]), positions=positions)
    x = x + (norm("post_attn_norm", o) if cfg.sandwich_norm else o)
    y, aux = _ffn(lp, norm("mlp_norm", x), cfg, kind)
    if cfg.sandwich_norm:
        y = norm("post_mlp_norm", y)
    aux_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    if aux is not None and training and cfg.router_aux_coef:
        aux_loss = router_load_balance_loss(
            aux["router_logits"], aux["expert_id"], cfg.num_experts)
    return x + y, aux_loss


def build_mrope_positions(batch, seq, vision_tokens, device=None):
    """M-RoPE ids (3, B, S) for the stub frontend's layout [text BOS]
    [vision grid][text...]: the vision tokens share t = 1 and take (h, w)
    grid ids; the text ids advance all three streams together."""
    gh = max(1, int(math.sqrt(max(vision_tokens, 1))))
    gw = -(-vision_tokens // gh) if vision_tokens else 1
    idx = torch.arange(seq, device=device)
    is_vis = (idx >= 1) & (idx < 1 + vision_tokens)
    v = (idx - 1).clamp(0, max(vision_tokens - 1, 0))
    t_id = torch.where(is_vis, 1, idx - torch.where(
        idx >= 1 + vision_tokens, vision_tokens - 1, 0))
    h_id = torch.where(is_vis, 1 + v // gw, t_id)
    w_id = torch.where(is_vis, 1 + v % gw, t_id)
    pos = torch.stack([t_id, h_id, w_id]).to(torch.int32)      # (3, S)
    return pos[:, None].expand(3, batch, seq)


def _default_positions(cfg, batch, seq, device=None):
    if cfg.mrope_sections is not None:
        return build_mrope_positions(batch, seq, cfg.vision_tokens, device)
    return torch.arange(seq, dtype=torch.int32,
                        device=device).expand(batch, seq)


def _embed(params, tokens, cfg):
    x = embedding_apply(params["embed"], tokens, compute_dtype=cfg.cdtype())
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def embed_inputs(params, batch_in, cfg: TransformerConfig):
    """Token embeddings in the compute dtype; with ``cfg.vision_tokens``
    the stub frontend's ``vision_embeds`` (B, Nv, d) take the positions
    after BOS (from ``min(1, S - Nv)``, where the JAX package's
    ``dynamic_update_slice`` clamps the start)."""
    x = _embed(params, batch_in["tokens"], cfg)
    if not cfg.vision_tokens:
        return x
    ve = batch_in["vision_embeds"].to(x.dtype)
    nv, S = ve.shape[1], x.shape[1]
    if nv > S:
        raise ValueError(f"{nv} vision embeddings do not fit in {S} "
                         f"positions")
    lo = min(1, S - nv)
    return torch.cat([x[:, :lo], ve, x[:, lo + nv:]], dim=1)


def unembed(params, x, cfg: TransformerConfig):
    if cfg.tie_embeddings:
        logits = embedding_attend(params["embed"], x,
                                  compute_dtype=cfg.cdtype())
    else:
        logits = dense_apply(params["unembed"], x,
                             compute_dtype=cfg.cdtype())
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return constrain_act(logits, cfg, kind="logits")


def forward(params, batch_in, cfg: TransformerConfig, *, training=False,
            collector_perm=None, cut_groups=1, return_hidden=False,
            last_token_only=False):
    """batch_in: {tokens (B, S) [, positions (B, S)]} -> (logits f32, aux).

    ``collector_perm``: SFPL's global-collector shuffle for split-LM
    training — a permutation of the batch applied to the smashed data
    after the first ``cut_groups`` layer groups (the client-side model
    portion); autograd's backward of the row gather is the de-shuffling
    scatter, Algorithm 1's gradient routing. Labels must be permuted by
    the caller (see ``core.split_lm.sfpl_lm_loss``).

    ``batch_in`` may hold ``vision_embeds`` (B, Nv, d) for the VLM and
    ``positions``, (3, B, S) under M-RoPE. ``aux`` is the sum of the MoE
    layers' router losses in training (0 without MoE or outside
    training). With ``cfg.remat and training`` each layer group (each
    layer, when a group holds several) is recomputed in the backward
    instead of stored.
    ``last_token_only`` keeps the final position (serving prefill);
    ``return_hidden`` returns the final-norm output instead of logits."""
    tokens = batch_in["tokens"]
    B, S = tokens.shape
    x = constrain_act(embed_inputs(params, batch_in, cfg), cfg)
    positions = batch_in.get("positions")
    if positions is None:
        positions = _default_positions(cfg, B, S, tokens.device)
    G = cfg.group_size
    order = units(cfg)

    def group_fn(x, u):
        stack, g, first = order[u]
        n = 1 if stack == "dense_layers" else G
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for p in range(n):
            f = lambda x_, g_, p=p: _layer_apply(
                _layer(params, g_, p, stack), x_, cfg,
                cfg.layer_kind(first + p), positions, training)
            # per-layer remat inside multi-layer groups
            x, aux = maybe_remat(f, cfg.remat and training and n > 1)(x, g)
            aux_total = aux_total + aux
        return constrain_act(x, cfg), aux_total

    # one checkpoint a group of one layer: nesting both double-recomputes
    body = maybe_remat(group_fn, cfg.remat and training and G == 1)

    def run_groups(x, lo, hi):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for u in range(lo, hi):
            x, a = body(x, u)
            aux = aux + a
        return x, aux

    if collector_perm is not None:
        # client-side portion -> smashed data -> global collector shuffle
        x, aux1 = run_groups(x, 0, cut_groups)
        x = take_rows(x, collector_perm)
        x, aux2 = run_groups(x, cut_groups, len(order))
        aux = aux1 + aux2
    else:
        x, aux = run_groups(x, 0, len(order))
    x = rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps,
                      scale_offset=cfg.norm_scale_offset)
    if last_token_only:
        x = x[:, -1:]
    if return_hidden:
        return x, aux
    return unembed(params, x, cfg).float(), aux


def update_expert_bias(params, counts, cfg: TransformerConfig):
    """``params`` with each dropless MoE layer's expert bias stepped by
    the counts its forward call recorded (``nn.moe.record_routing``, in
    the forward's order: units, then layers within a group)."""
    if not counts:
        return params
    it = iter(counts)
    new = {}
    for stack, g, first in units(cfg):
        n = 1 if stack == "dense_layers" else cfg.group_size
        for p in range(n):
            if cfg.layer_kind(first + p)["moe"]:
                new.setdefault((stack, p), []).append(next(it))
    out = dict(params)
    for (stack, p), cs in new.items():
        moe = params[stack][f"sub{p}"]["moe"]
        bias = expert_bias_step(moe["expert_bias"], torch.stack(cs),
                                cfg.expert_bias_rate)
        out[stack] = {**out[stack], f"sub{p}": {
            **out[stack][f"sub{p}"], "moe": {**moe, "expert_bias": bias}}}
    return out


def loss_fn(params, batch_in, cfg: TransformerConfig, *, training=True):
    """Mean next-token cross-entropy of ``batch_in["labels"]`` through
    ``chunked_lm_loss``, plus the router loss; returns ``(loss, {"xent",
    "aux"})``."""
    hidden, aux_loss = forward(params, batch_in, cfg, training=training,
                               return_hidden=True)
    loss = chunked_lm_loss(hidden, batch_in["labels"],
                           lambda xc: unembed(params, xc, cfg))
    return loss + cfg.router_aux_coef * aux_loss, {"xent": loss,
                                                   "aux": aux_loss}


# --------------------------------------------------------------------------
# decode (KV cache)

def init_decode_state(cfg: TransformerConfig, batch, max_len, *,
                      dtype=torch.bfloat16, device=None):
    """Stacked per-group KV caches (leading ``num_groups`` axis). SWA layers
    get window-sized ring slots."""
    if cfg.num_dense_layers:
        raise NotImplementedError("decode of a model with leading dense "
                                  "layers")
    num_groups = cfg.num_layers // cfg.group_size
    cache = {}
    for p in range(cfg.group_size):
        kind = cfg.layer_kind(p)
        slots = min(max_len, kind["window"] or max_len)
        one = init_kv_cache(batch, slots, cfg.num_kv_heads, cfg.head_dim,
                            dtype=dtype, device=device)
        cache[f"sub{p}"] = tree_map(
            lambda a: a[None].repeat((num_groups,) + (1,) * a.dim()), one)
    return cache


def decode_step(params, state, tokens, cfg: TransformerConfig, *, cur_pos):
    """tokens: (B, 1); state: the stacked caches; cur_pos: an int or a (B,)
    int tensor of per-slot positions. Writes the caches in place and
    returns (logits (B, 1, V) f32, state)."""
    if cfg.num_dense_layers or cfg.sandwich_norm:
        raise NotImplementedError("decode of afmoe's layers")
    x = _embed(params, tokens, cfg)
    G = cfg.group_size
    for g in range(cfg.num_layers // G):
        for p in range(G):
            kind = cfg.layer_kind(p)
            lp = cast_for_compute(_layer(params, g, p), cfg)
            cache = {k: a[g] for k, a in state[f"sub{p}"].items()}
            h = rmsnorm_apply(lp["attn_norm"], x, eps=cfg.norm_eps,
                              scale_offset=cfg.norm_scale_offset)
            attn_out, _ = attention_decode(
                lp["attn"], h, _attn_cfg(cfg, kind["window"]), cache=cache,
                cur_pos=cur_pos)
            x = x + attn_out
            h = rmsnorm_apply(lp["mlp_norm"], x, eps=cfg.norm_eps,
                              scale_offset=cfg.norm_scale_offset)
            x = x + _ffn(lp, h, cfg, kind)[0]
    x = rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps,
                      scale_offset=cfg.norm_scale_offset)
    return unembed(params, x, cfg).float(), state
