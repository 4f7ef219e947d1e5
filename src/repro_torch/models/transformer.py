"""Decoder-only transformer family: the dense GQA architectures (qwen3-8b
and its kin), for prefill and cached decode.

Layers are grouped into units of ``cfg.group_size`` (the lcm of the
MoE-period and attention-pattern period); per-group parameters are stacked
on a leading ``num_groups`` axis exactly as the JAX package stacks them, so
parameter trees carry across (``repro_torch.convert``). The JAX package's
``lax.scan`` over the groups is a Python loop here. MoE layers, the VLM
stub frontend and SFPL LM training (``collector_perm``) belong to later
slices of the port and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import TransformerConfig, constrain_act
from repro_torch.nn.attention import (
    AttnConfig, attention_init, attention_apply, attention_decode,
    init_kv_cache)
from repro_torch.nn.linear import (
    dense_init, dense_apply, embedding_init, embedding_apply,
    embedding_attend)
from repro_torch.nn.mlp import mlp_init, mlp_apply
from repro_torch.nn.norm import rmsnorm_init, rmsnorm_apply
from repro_torch.tree import tree_map, tree_map_with_path

MOE_SLICE = ("MoE layers (nn/moe.py) belong to the MoE slice of the port, "
             "which is not ported yet")


def _attn_cfg(cfg: TransformerConfig, window):
    return AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        qk_norm=cfg.qk_norm, use_bias=cfg.attn_bias,
        rope_theta=cfg.rope_theta, mrope_sections=cfg.mrope_sections,
        sliding_window=window, impl=cfg.attention_impl,
        mesh_axes=cfg.mesh_axes)


# --------------------------------------------------------------------------
# init

def _layer_init(gen, cfg: TransformerConfig, kind):
    if kind["moe"]:
        raise NotImplementedError(MOE_SLICE)
    dt = cfg.pdtype()
    return {
        "attn_norm": rmsnorm_init(gen, cfg.d_model, dtype=dt),
        "attn": attention_init(gen, _attn_cfg(cfg, kind["window"]),
                               dtype=dt),
        "mlp_norm": rmsnorm_init(gen, cfg.d_model, dtype=dt),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff_dense or cfg.d_ff,
                        gated=cfg.act in ("silu", "gelu"), dtype=dt),
    }


def init(gen, cfg: TransformerConfig):
    """Parameters drawn from ``gen`` on its device (a CUDA generator makes
    them on the card). Groups are written one at a time into the stacked
    leaves, so the peak is the model plus one group."""
    G = cfg.group_size
    if cfg.num_layers % G:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple of "
                         f"the group size {G}")
    num_groups = cfg.num_layers // G
    dt = cfg.pdtype()
    params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype=dt),
        "final_norm": rmsnorm_init(gen, cfg.d_model, dtype=dt),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       use_bias=False, dtype=dt)

    def one_group():
        return {f"sub{p}": _layer_init(gen, cfg, cfg.layer_kind(p))
                for p in range(G)}

    group = one_group()
    layers = tree_map(lambda a: a.new_empty((num_groups,) + a.shape), group)
    for g in range(num_groups):
        if g:
            group = one_group()
        tree_map(lambda dst, src, g=g: dst[g].copy_(src), layers, group)
    params["layers"] = layers
    return params


# --------------------------------------------------------------------------
# forward

def cast_for_compute(tree, cfg: TransformerConfig):
    """Cast float params to the compute dtype (router weights stay f32)."""
    cd = cfg.cdtype()

    def leafcast(path, a):
        if "router" in path or not a.is_floating_point():
            return a
        return a.to(cd)
    return tree_map_with_path(leafcast, tree)


def _layer(params, g, p):
    """Layer ``p`` of group ``g``: views into the stacked leaves."""
    return tree_map(lambda a: a[g], params["layers"][f"sub{p}"])


def _layer_apply(lp, x, cfg: TransformerConfig, kind, positions):
    if kind["moe"]:
        raise NotImplementedError(MOE_SLICE)
    lp = cast_for_compute(lp, cfg)
    h = rmsnorm_apply(lp["attn_norm"], x, eps=cfg.norm_eps,
                      scale_offset=cfg.norm_scale_offset)
    x = x + attention_apply(lp["attn"], h, _attn_cfg(cfg, kind["window"]),
                            positions=positions)
    h = rmsnorm_apply(lp["mlp_norm"], x, eps=cfg.norm_eps,
                      scale_offset=cfg.norm_scale_offset)
    return x + mlp_apply(lp["mlp"], h, act=cfg.act)


def _default_positions(cfg, batch, seq, device=None):
    if cfg.mrope_sections is not None:
        raise NotImplementedError(
            "M-RoPE positions (qwen2-vl) belong to the VLM slice of the port")
    return torch.arange(seq, dtype=torch.int32,
                        device=device).expand(batch, seq)


def _embed(params, tokens, cfg):
    x = embedding_apply(params["embed"], tokens, compute_dtype=cfg.cdtype())
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def embed_inputs(params, batch_in, cfg: TransformerConfig):
    """Token embeddings in the compute dtype."""
    if cfg.vision_tokens:
        raise NotImplementedError(
            "vision_tokens (the VLM stub frontend) belong to the VLM slice "
            "of the port")
    return _embed(params, batch_in["tokens"], cfg)


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
            collector_perm=None, return_hidden=False, last_token_only=False):
    """batch_in: {tokens (B, S) [, positions (B, S)]} -> (logits f32, aux).

    ``aux`` is the MoE router loss, 0 for the dense layers of this slice;
    ``training`` changes no value here (no dropout, and rematerialisation
    is a JAX memory policy). ``last_token_only`` keeps the final position
    (serving prefill); ``return_hidden`` returns the final-norm output
    instead of logits."""
    del training
    if collector_perm is not None:
        raise NotImplementedError(
            "collector_perm (SFPL LM training) belongs to the LM-training "
            "slice of the port")
    tokens = batch_in["tokens"]
    B, S = tokens.shape
    x = constrain_act(embed_inputs(params, batch_in, cfg), cfg)
    positions = batch_in.get("positions")
    if positions is None:
        positions = _default_positions(cfg, B, S, tokens.device)
    G = cfg.group_size
    for g in range(cfg.num_layers // G):
        for p in range(G):
            x = _layer_apply(_layer(params, g, p), x, cfg, cfg.layer_kind(p),
                             positions)
        x = constrain_act(x, cfg)
    x = rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps,
                      scale_offset=cfg.norm_scale_offset)
    if last_token_only:
        x = x[:, -1:]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return unembed(params, x, cfg).float(), aux


# --------------------------------------------------------------------------
# decode (KV cache)

def init_decode_state(cfg: TransformerConfig, batch, max_len, *,
                      dtype=torch.bfloat16, device=None):
    """Stacked per-group KV caches (leading ``num_groups`` axis). SWA layers
    get window-sized ring slots."""
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
    x = _embed(params, tokens, cfg)
    G = cfg.group_size
    for g in range(cfg.num_layers // G):
        for p in range(G):
            kind = cfg.layer_kind(p)
            if kind["moe"]:
                raise NotImplementedError(MOE_SLICE)
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
            x = x + mlp_apply(lp["mlp"], h, act=cfg.act)
    x = rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps,
                      scale_offset=cfg.norm_scale_offset)
    return unembed(params, x, cfg).float(), state
