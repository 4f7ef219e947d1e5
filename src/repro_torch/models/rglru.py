"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU + local-MQA hybrid,
for training (``loss_fn``), prefill and cached decode.

The block pattern is (recurrent, recurrent, local attention) repeating:
recurrentgemma-9b's 38 layers are 12 full triples plus 2 trailing
recurrent blocks. Each block is residual: temporal mixing, then a GeGLU
MLP.

The RG-LRU diagonal linear recurrence
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
runs over the whole sequence as the JAX package's
``jax.lax.associative_scan`` does (:func:`associative_scan`: the same
odd/even recursion, in plain tensor ops), and as one elementwise step in
decode. Local attention is the shared GQA layer with a 2048-token sliding
window (K7 on the kernel path), so the decode state is O(window).

Per-group parameters are stacked on a leading ``num_groups`` axis as the
JAX package stacks them, plus the ``trailing`` group's, so parameter trees
carry across (``repro_torch.convert``); its ``lax.scan`` over the groups
is a Python loop here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import (chunked_lm_loss, constrain_act,
                                       constrain_dims, maybe_remat,
                                       stacked_init)
from repro_torch.models.xlstm import (causal_conv_init, causal_conv_apply,
                                      causal_conv_step)
from repro_torch.nn.attention import (
    AttnConfig, attention_init, attention_apply, attention_decode,
    init_kv_cache)
from repro_torch.nn.init import normal_init
from repro_torch.nn.linear import (
    dense_init, dense_apply, embedding_init, embedding_apply,
    embedding_attend)
from repro_torch.nn.norm import rmsnorm_init, rmsnorm_apply
from repro_torch.sharding.dtensor import dims_spec, gather_rows, local_region
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    name: str = "recurrentgemma"
    num_layers: int = 38
    d_model: int = 4096
    num_heads: int = 16
    num_kv_heads: int = 1          # MQA
    head_dim: int = 256
    d_ff: int = 12288
    vocab_size: int = 256000
    d_rnn: int = 0                 # 0 -> d_model
    conv_kernel: int = 4
    window: int = 2048
    lru_c: float = 8.0
    norm_eps: float = 1e-6
    embed_scale: bool = True       # gemma convention
    norm_scale_offset: float = 1.0
    pattern: tuple = ("rec", "rec", "attn")
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attention_impl: str = "xla"    # "xla" | "kernel" (K7)
    remat: bool = True
    mesh_axes: Optional[tuple] = None

    @property
    def rnn_width(self):
        return self.d_rnn or self.d_model

    @property
    def num_groups(self):
        return self.num_layers // len(self.pattern)

    @property
    def num_trailing(self):
        return self.num_layers % len(self.pattern)

    def pdtype(self):
        return getattr(torch, self.param_dtype)

    def cdtype(self):
        return getattr(torch, self.compute_dtype)


def _attn_cfg(cfg: RGLRUConfig):
    return AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rope_theta=10000.0, sliding_window=cfg.window,
        impl=cfg.attention_impl, mesh_axes=cfg.mesh_axes)


# --------------------------------------------------------------------------
# RG-LRU cell

def rglru_init(gen, width, dtype):
    # a ~ uniform(0.9, 0.999) at r = 0.5 (the Griffin paper's appendix)
    return {
        "lambda": normal_init(gen, (width,), stddev=0.5,
                              dtype=torch.float32) + 4.0,
        "w_r": dense_init(gen, width, width, use_bias=True, dtype=dtype),
        "w_i": dense_init(gen, width, width, use_bias=True, dtype=dtype),
    }


def _rglru_gates(p, x, c):
    """(a, b) of the recurrence in f32. ``softplus`` is ``jax.nn``'s,
    ``logaddexp(lam, 0)``, in the dtype of ``lam`` (the compute dtype,
    as the JAX package casts it); ``1 - a^2`` is ``1 - exp(2 log_a)``
    floored at 1e-12."""
    r = torch.sigmoid(dense_apply(p["w_r"], x).float())
    i = torch.sigmoid(dense_apply(p["w_i"], x).float())
    lam = p["lambda"]
    log_a = -c * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    gated_x = i * x.float()
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a),
                                   1e-12)) * gated_x
    return a, b


def _interleave(even, odd):
    """Rows of ``even`` at the even positions of axis 1, ``odd``'s at the
    odd ones (``even`` has as many rows as ``odd`` or one more)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n) + tuple(even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a, b):
    """Prefix of ``(a_t, b_t)`` under ``(a1, b1) . (a2, b2) = (a1 a2,
    a2 b1 + b2)`` along axis 1: ``h_t = a_t h_{t-1} + b_t`` from ``h_{-1}
    = 0``. Returns ``(prod a, h)``.

    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs,
    scan the halved sequence, combine the evens, interleave. O(S) work in
    about 2 log2(S) levels, each a few elementwise ops over the sequence,
    with the JAX package's order of combines."""
    n = a.shape[1]
    if n < 2:
        return a, b
    a1, b1, a2, b2 = a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2]
    odd_a, odd_b = associative_scan(a1 * a2, a2 * b1 + b2)
    # the evens past the first: an odd prefix, then the next even element
    pa, pb = (odd_a, odd_b) if n % 2 else (odd_a[:, :-1], odd_b[:, :-1])
    a3, b3 = a[:, 2::2], b[:, 2::2]
    even_a = torch.cat([a[:, :1], pa * a3], dim=1)
    even_b = torch.cat([b[:, :1], a3 * pb + b3], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def rglru_apply(p, x, *, c=8.0, mesh_axes=None):
    """x: (B, S, W) -> (B, S, W): the recurrence over S by
    :func:`associative_scan` in f32, returned in ``x.dtype``."""
    a, b = _rglru_gates(p, x, c)
    a = constrain_dims(a, mesh_axes, ("dp", None, "tp"))
    b = constrain_dims(b, mesh_axes, ("dp", None, "tp"))
    # the scan runs along the sequence, whole on each device
    spec = dims_spec(a.shape, mesh_axes, ("dp", None, "tp")) \
        if mesh_axes else None
    h = local_region(lambda a_, b_: associative_scan(a_, b_)[1], mesh_axes,
                     [spec, spec], spec)(a, b)
    return h.to(x.dtype)


def rglru_step(p, x_t, h_prev, *, c=8.0):
    """x_t: (B, W); h_prev: (B, W) f32. Returns (y, h_new)."""
    a, b = _rglru_gates(p, x_t, c)
    h_new = a * h_prev + b
    return h_new.to(x_t.dtype), h_new


# --------------------------------------------------------------------------
# blocks

def rec_block_init(gen, cfg: RGLRUConfig):
    dt = cfg.pdtype()
    W = cfg.rnn_width
    return {
        "norm": rmsnorm_init(gen, cfg.d_model, dtype=dt),
        "up_main": dense_init(gen, cfg.d_model, W, use_bias=False,
                              dtype=dt),
        "up_gate": dense_init(gen, cfg.d_model, W, use_bias=False,
                              dtype=dt),
        "conv": causal_conv_init(gen, W, cfg.conv_kernel, dt),
        "lru": rglru_init(gen, W, dt),
        "down": dense_init(gen, W, cfg.d_model, use_bias=False, dtype=dt),
    }


def attn_block_init(gen, cfg: RGLRUConfig):
    return {
        "norm": rmsnorm_init(gen, cfg.d_model, dtype=cfg.pdtype()),
        "attn": attention_init(gen, _attn_cfg(cfg), dtype=cfg.pdtype()),
    }


def mlp_block_init(gen, cfg: RGLRUConfig):
    dt = cfg.pdtype()
    return {
        "norm": rmsnorm_init(gen, cfg.d_model, dtype=dt),
        "up": dense_init(gen, cfg.d_model, 2 * cfg.d_ff, use_bias=False,
                         dtype=dt),
        "down": dense_init(gen, cfg.d_ff, cfg.d_model, use_bias=False,
                           dtype=dt),
    }


def _norm(p, x, cfg: RGLRUConfig):
    return rmsnorm_apply(p, x, eps=cfg.norm_eps,
                         scale_offset=cfg.norm_scale_offset)


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def _mlp_apply(p, x, cfg: RGLRUConfig):
    a, b = dense_apply(p["up"], _norm(p["norm"], x, cfg)).chunk(2, dim=-1)
    return dense_apply(p["down"], _gelu(a) * b).to(x.dtype)


def rec_block_apply(p, x, cfg: RGLRUConfig):
    h = gather_rows(_norm(p["norm"], x, cfg))   # once for both branches
    main = constrain_dims(dense_apply(p["up_main"], h), cfg.mesh_axes,
                          ("dp", None, "tp"))
    gate = _gelu(dense_apply(p["up_gate"], h))
    conv = causal_conv_apply(p["conv"], main)
    y = rglru_apply(p["lru"], conv, c=cfg.lru_c, mesh_axes=cfg.mesh_axes)
    return dense_apply(p["down"], y * gate).to(x.dtype)


def rec_block_step(p, x_t, state, cfg: RGLRUConfig):
    """x_t: (B, 1, d). state: {conv_buf, h}. Returns (out, new state)."""
    h = _norm(p["norm"], x_t, cfg)[:, 0]
    main = dense_apply(p["up_main"], h)
    gate = _gelu(dense_apply(p["up_gate"], h))
    conv_y, new_buf = causal_conv_step(p["conv"], main, state["conv_buf"])
    y, h_new = rglru_step(p["lru"], conv_y, state["h"], c=cfg.lru_c)
    out = dense_apply(p["down"], y * gate)
    return out[:, None].to(x_t.dtype), {"conv_buf": new_buf, "h": h_new}


def attn_block_apply(p, x, cfg: RGLRUConfig, positions):
    h = _norm(p["norm"], x, cfg)
    return attention_apply(p["attn"], h, _attn_cfg(cfg),
                           positions=positions).to(x.dtype)


# --------------------------------------------------------------------------
# full model

def _cast(tree, cfg: RGLRUConfig):
    """Every float leaf in the compute dtype (``lambda`` too)."""
    cd = cfg.cdtype()
    return tree_map(lambda a: a.to(cd) if a.is_floating_point() else a, tree)


def _group_init(gen, cfg: RGLRUConfig, pattern):
    return {f"sub{i}": {"mix": (rec_block_init if kind == "rec"
                                else attn_block_init)(gen, cfg),
                        "mlp": mlp_block_init(gen, cfg)}
            for i, kind in enumerate(pattern)}


def init(gen, cfg: RGLRUConfig):
    """Parameters drawn from ``gen`` on its device (a CUDA generator makes
    them on the card), the groups stacked by ``stacked_init`` (the peak is
    the model plus one group), then the trailing group's."""
    dt = cfg.pdtype()
    params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype=dt),
        "final_norm": rmsnorm_init(gen, cfg.d_model, dtype=dt),
        "layers": stacked_init(lambda: _group_init(gen, cfg, cfg.pattern),
                               cfg.num_groups),
    }
    if cfg.num_trailing:
        params["trailing"] = _group_init(gen, cfg,
                                         cfg.pattern[:cfg.num_trailing])
    return params


def _apply_group(gp, x, cfg: RGLRUConfig, positions, pattern, *,
                 remat=False):
    """The sub-blocks of one group; ``remat`` recomputes each in the
    backward instead of storing its activations."""
    def one(x, sub, kind):
        sub = _cast(sub, cfg)
        if kind == "rec":
            x = x + rec_block_apply(sub["mix"], x, cfg)
        else:
            x = x + attn_block_apply(sub["mix"], x, cfg, positions)
        return x + _mlp_apply(sub["mlp"], x, cfg)

    for i, kind in enumerate(pattern):
        f = lambda x_, s_, kind=kind: one(x_, s_, kind)
        x = maybe_remat(f, remat)(x, gp[f"sub{i}"])
    return x


def _group(params, g):
    """Group ``g``: views into the stacked leaves."""
    return tree_map(lambda a: a[g], params["layers"])


def _embed(params, tokens, cfg: RGLRUConfig):
    x = embedding_apply(params["embed"], tokens, compute_dtype=cfg.cdtype())
    if cfg.embed_scale:
        # sqrt(d) rounded to the compute dtype, as the JAX package does
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(params, x, cfg: RGLRUConfig):
    logits = embedding_attend(params["embed"], x, compute_dtype=cfg.cdtype())
    return constrain_act(logits, cfg, kind="logits")


def forward(params, batch_in, cfg: RGLRUConfig, *, training=False,
            return_hidden=False, last_token_only=False):
    """batch_in: {tokens (B, S)} -> (logits f32, aux 0). With ``cfg.remat
    and training`` each sub-block of the stacked groups is recomputed in
    the backward; ``last_token_only`` keeps the final position (serving
    prefill); ``return_hidden`` returns the final-norm output instead of
    logits."""
    tokens = batch_in["tokens"]
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    for g in range(cfg.num_groups):
        x = _apply_group(_group(params, g), x, cfg, positions, cfg.pattern,
                         remat=cfg.remat and training)
        x = constrain_act(x, cfg)
    if cfg.num_trailing:
        x = _apply_group(params["trailing"], x, cfg, positions,
                         cfg.pattern[:cfg.num_trailing])
    x = _norm(params["final_norm"], x, cfg)
    if last_token_only:
        x = x[:, -1:]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return unembed(params, x, cfg).float(), aux


def loss_fn(params, batch_in, cfg: RGLRUConfig, *, training=True):
    """Mean next-token cross-entropy of ``batch_in["labels"]`` through
    ``chunked_lm_loss``; returns ``(loss, {"xent"})``."""
    hidden, _ = forward(params, batch_in, cfg, training=training,
                        return_hidden=True)
    loss = chunked_lm_loss(hidden, batch_in["labels"],
                           lambda xc: unembed(params, xc, cfg))
    return loss, {"xent": loss}


# --------------------------------------------------------------------------
# decode

def _sub_state_init(cfg: RGLRUConfig, kind, batch, max_len, dtype, device):
    """A rec block's {conv_buf (compute dtype), h (f32)}, or an attention
    block's ring cache of ``min(max_len, window)`` slots."""
    if kind == "rec":
        return {"conv_buf": torch.zeros(
                    (batch, cfg.conv_kernel - 1, cfg.rnn_width),
                    dtype=cfg.cdtype(), device=device),
                "h": torch.zeros((batch, cfg.rnn_width), dtype=torch.float32,
                                 device=device)}
    return init_kv_cache(batch, min(max_len, cfg.window), cfg.num_kv_heads,
                         cfg.head_dim, dtype=dtype, device=device)


def init_decode_state(cfg: RGLRUConfig, batch, max_len, *,
                      dtype=torch.bfloat16, device=None):
    """{"groups": per-sub-block states stacked on a leading ``num_groups``
    axis, "trailing": the trailing blocks' states}. The stacked states are
    copies (``repeat``), not views of one group's: decode writes them in
    place."""
    state = {"groups": {}, "trailing": {}}
    for i, kind in enumerate(cfg.pattern):
        one = _sub_state_init(cfg, kind, batch, max_len, dtype, device)
        state["groups"][f"sub{i}"] = tree_map(
            lambda a: a[None].repeat((cfg.num_groups,) + (1,) * a.dim()),
            one)
    for i, kind in enumerate(cfg.pattern[:cfg.num_trailing]):
        state["trailing"][f"sub{i}"] = _sub_state_init(
            cfg, kind, batch, max_len, dtype, device)
    return state


def _step_group(gp, gs, x, cfg: RGLRUConfig, cur_pos, pattern):
    """One token through a group's sub-blocks; writes the states ``gs``
    (views into the decode state) in place."""
    for i, kind in enumerate(pattern):
        sub = _cast(gp[f"sub{i}"], cfg)
        st = gs[f"sub{i}"]
        if kind == "rec":
            d, new = rec_block_step(sub["mix"], x, st, cfg)
            for k, a in new.items():
                st[k].copy_(a)
            x = x + d
        else:
            h = _norm(sub["mix"]["norm"], x, cfg)
            d, _ = attention_decode(sub["mix"]["attn"], h, _attn_cfg(cfg),
                                    cache=st, cur_pos=cur_pos)
            x = x + d.to(x.dtype)
        x = x + _mlp_apply(sub["mlp"], x, cfg)
    return x


def decode_step(params, state, tokens, cfg: RGLRUConfig, *, cur_pos):
    """tokens: (B, 1); cur_pos: an int or a (B,) int tensor. Writes the
    recurrent states and the ring caches in place and returns (logits
    (B, 1, V) f32, state)."""
    x = _embed(params, tokens, cfg)
    for g in range(cfg.num_groups):
        gs = {k: {n: a[g] for n, a in sub.items()}
              for k, sub in state["groups"].items()}
        x = _step_group(_group(params, g), gs, x, cfg, cur_pos, cfg.pattern)
    if cfg.num_trailing:
        x = _step_group(params["trailing"], state["trailing"], x, cfg,
                        cur_pos, cfg.pattern[:cfg.num_trailing])
    x = _norm(params["final_norm"], x, cfg)
    return unembed(params, x, cfg).float(), state
