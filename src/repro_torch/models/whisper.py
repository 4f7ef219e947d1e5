"""Whisper-large-v3's backbone (arXiv:2212.04356): an encoder-decoder
transformer, for training (``loss_fn``), prefill and cached decode.

The modality frontend (mel spectrogram and the two-conv feature extractor)
is a stub, as in the JAX package: the caller supplies frame embeddings
(B, frames, d_model). The model is the transformer that consumes them: a
bidirectional encoder with sinusoidal positions, and a causal decoder with
learned positions, cross-attention, LayerNorm and GELU MLPs. The two
self-attentions go through K7 on the kernel path (the encoder's
non-causal); cross-attention always takes the plain path, as the JAX
package's does.

The decoder's learned positions end at ``max_target_positions``. Past
them the JAX package's gather fills NaN; the port raises ``ValueError``
instead (:func:`decode_train`, :func:`decode_step`).

Per-layer parameters are stacked on a leading ``num_layers`` axis as the
JAX package stacks them, so parameter trees carry across
(``repro_torch.convert``); its ``lax.scan`` over the layers is a Python
loop here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.models.common import (chunked_lm_loss, constrain_act,
                                       maybe_remat, stacked_init)
from repro_torch.nn.attention import (
    AttnConfig, attention_init, attention_apply, attention_decode,
    init_kv_cache)
from repro_torch.nn.linear import (
    dense_apply, embedding_init, embedding_apply, embedding_attend)
from repro_torch.nn.mlp import mlp_init, mlp_apply
from repro_torch.nn.norm import layernorm_init, layernorm_apply
from repro_torch.sharding.dtensor import gather_rows, split_last
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str = "whisper"
    num_layers: int = 32            # per side (encoder and decoder)
    d_model: int = 1280
    num_heads: int = 20
    num_kv_heads: int = 20
    head_dim: int = 64
    d_ff: int = 5120
    vocab_size: int = 51866
    max_source_positions: int = 1500
    max_target_positions: int = 448
    norm_eps: float = 1e-5
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attention_impl: str = "xla"     # "xla" | "kernel" (K7)
    remat: bool = True
    mesh_axes: Optional[tuple] = None

    def pdtype(self):
        return getattr(torch, self.param_dtype)

    def cdtype(self):
        return getattr(torch, self.compute_dtype)


def _attn_cfg(cfg: WhisperConfig):
    return AttnConfig(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        use_bias=True, use_rope=False, impl=cfg.attention_impl,
        mesh_axes=cfg.mesh_axes)


def sinusoidal_positions(length, dim, device=None):
    """Whisper encoder's fixed sinusoidal table, (length, dim) f32."""
    log_timescale = math.log(10000.0) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(dim // 2,
                                                  dtype=torch.float32,
                                                  device=device))
    scaled = torch.arange(length, dtype=torch.float32,
                          device=device)[:, None] * inv[None]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


# --------------------------------------------------------------------------
# init

def _enc_layer_init(gen, cfg: WhisperConfig):
    dt = cfg.pdtype()
    return {
        "attn_norm": layernorm_init(gen, cfg.d_model, dtype=dt),
        "attn": attention_init(gen, _attn_cfg(cfg), dtype=dt),
        "mlp_norm": layernorm_init(gen, cfg.d_model, dtype=dt),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False, dtype=dt),
    }


def _dec_layer_init(gen, cfg: WhisperConfig):
    dt = cfg.pdtype()
    return {
        "self_norm": layernorm_init(gen, cfg.d_model, dtype=dt),
        "self_attn": attention_init(gen, _attn_cfg(cfg), dtype=dt),
        "cross_norm": layernorm_init(gen, cfg.d_model, dtype=dt),
        "cross_attn": attention_init(gen, _attn_cfg(cfg), dtype=dt),
        "mlp_norm": layernorm_init(gen, cfg.d_model, dtype=dt),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False, dtype=dt),
    }


def init(gen, cfg: WhisperConfig, *, max_target_positions=None):
    """Parameters drawn from ``gen`` on its device (a CUDA generator makes
    them on the card), each side's layers stacked by ``stacked_init``;
    ``max_target_positions`` overrides the config's length of the learned
    position table."""
    mtp = max_target_positions or cfg.max_target_positions
    dt = cfg.pdtype()
    L = cfg.num_layers
    return {
        "enc_layers": stacked_init(lambda: _enc_layer_init(gen, cfg), L),
        "dec_layers": stacked_init(lambda: _dec_layer_init(gen, cfg), L),
        "enc_norm": layernorm_init(gen, cfg.d_model, dtype=dt),
        "dec_norm": layernorm_init(gen, cfg.d_model, dtype=dt),
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model, dtype=dt),
        "pos_embed": embedding_init(gen, mtp, cfg.d_model, dtype=dt),
    }


def _cast(tree, cfg: WhisperConfig):
    cd = cfg.cdtype()
    return tree_map(lambda a: a.to(cd) if a.is_floating_point() else a, tree)


def _layer(stack, i):
    """Layer ``i``: views into the stacked leaves."""
    return tree_map(lambda a: a[i], stack)


def _ln(p, x, cfg: WhisperConfig):
    return layernorm_apply(p, x, eps=cfg.norm_eps)


def _check_positions(params, last, cfg: WhisperConfig):
    """Raise unless decoder position ``last`` has a learned embedding."""
    n = params["pos_embed"]["table"].shape[0]
    if last >= n:
        raise ValueError(
            f"decoder position {last} is past the {n} learned positions "
            f"(max_target_positions={cfg.max_target_positions}; the JAX "
            f"package returns NaN there)")


# --------------------------------------------------------------------------
# encoder

def encode(params, frame_embeds, cfg: WhisperConfig, *, training=False):
    """frame_embeds: (B, Sf, d) stub-frontend output -> encoder states."""
    B, Sf, _ = frame_embeds.shape
    x = frame_embeds.to(cfg.cdtype())
    x = x + sinusoidal_positions(Sf, cfg.d_model,
                                 x.device).to(x.dtype)[None]
    positions = torch.arange(Sf, dtype=torch.int32,
                             device=x.device).expand(B, Sf)

    def layer_fn(x, i):
        lp = _cast(_layer(params["enc_layers"], i), cfg)
        x = x + attention_apply(lp["attn"], _ln(lp["attn_norm"], x, cfg),
                                _attn_cfg(cfg), positions=positions,
                                causal=False)
        x = x + mlp_apply(lp["mlp"], _ln(lp["mlp_norm"], x, cfg),
                          act="gelu")
        return constrain_act(x, cfg)

    body = maybe_remat(layer_fn, cfg.remat and training)
    for i in range(cfg.num_layers):
        x = body(x, i)
    return _ln(params["enc_norm"], x, cfg)


# --------------------------------------------------------------------------
# decoder

def _cross_kv(ap, enc_states, cfg: WhisperConfig):
    B, Sf, _ = enc_states.shape
    K, D = cfg.num_kv_heads, cfg.head_dim
    enc_states = gather_rows(enc_states)        # once for k and v
    k = split_last(dense_apply(ap["wk"], enc_states), K, D)
    v = split_last(dense_apply(ap["wv"], enc_states), K, D)
    return k, v


def decode_train(params, tokens, enc_states, cfg: WhisperConfig, *,
                 training=False, return_hidden=False):
    """Teacher-forced decoder pass. tokens: (B, St), St at most the
    learned positions (else ``ValueError``)."""
    B, St = tokens.shape
    _check_positions(params, St - 1, cfg)
    x = embedding_apply(params["embed"], tokens, compute_dtype=cfg.cdtype())
    pos_ids = torch.arange(St, device=tokens.device)
    x = x + embedding_apply(params["pos_embed"], pos_ids,
                            compute_dtype=cfg.cdtype())[None]
    positions = pos_ids.to(torch.int32).expand(B, St)
    enc_kv = enc_states.to(cfg.cdtype())

    def layer_fn(x, i):
        lp = _cast(_layer(params["dec_layers"], i), cfg)
        x = x + attention_apply(lp["self_attn"],
                                _ln(lp["self_norm"], x, cfg), _attn_cfg(cfg),
                                positions=positions, causal=True)
        k, v = _cross_kv(lp["cross_attn"], enc_kv, cfg)
        x = x + attention_apply(lp["cross_attn"],
                                _ln(lp["cross_norm"], x, cfg),
                                _attn_cfg(cfg), positions=positions,
                                kv_override=(k, v, None))
        x = x + mlp_apply(lp["mlp"], _ln(lp["mlp_norm"], x, cfg),
                          act="gelu")
        return constrain_act(x, cfg)

    body = maybe_remat(layer_fn, cfg.remat and training)
    for i in range(cfg.num_layers):
        x = body(x, i)
    x = _ln(params["dec_norm"], x, cfg)
    if return_hidden:
        return x
    return unembed(params, x, cfg).float()


def unembed(params, x, cfg: WhisperConfig):
    logits = embedding_attend(params["embed"], x, compute_dtype=cfg.cdtype())
    return constrain_act(logits, cfg, kind="logits")


def forward(params, batch_in, cfg: WhisperConfig, *, training=False,
            return_hidden=False, last_token_only=False):
    """batch_in: {frame_embeds (B, Sf, d), tokens (B, St)} -> (logits f32,
    aux 0). ``last_token_only`` keeps the final position (serving
    prefill); ``return_hidden`` returns the final-norm output instead of
    logits."""
    enc = encode(params, batch_in["frame_embeds"], cfg, training=training)
    hidden = decode_train(params, batch_in["tokens"], enc, cfg,
                          training=training, return_hidden=True)
    if last_token_only:
        hidden = hidden[:, -1:]
    aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    if return_hidden:
        return hidden, aux
    return unembed(params, hidden, cfg).float(), aux


def loss_fn(params, batch_in, cfg: WhisperConfig, *, training=True):
    """Mean next-token cross-entropy of ``batch_in["labels"]`` through
    ``chunked_lm_loss``; returns ``(loss, {"xent"})``."""
    hidden, _ = forward(params, batch_in, cfg, training=training,
                        return_hidden=True)
    loss = chunked_lm_loss(hidden, batch_in["labels"],
                           lambda xc: unembed(params, xc, cfg))
    return loss, {"xent": loss}


# --------------------------------------------------------------------------
# incremental decode (self-attention KV cache + precomputed cross K/V)

def init_decode_state(cfg: WhisperConfig, batch, max_len, *,
                      dtype=torch.bfloat16, enc_frames=None, device=None):
    """{"self": per-layer KV caches of ``max_len`` slots stacked on a
    leading ``num_layers`` axis (copies: decode writes them in place),
    "cross_k" / "cross_v": (L, B, enc_frames, K, D) zeros, filled by
    :func:`prefill_cross`}."""
    ef = enc_frames or cfg.max_source_positions
    L = cfg.num_layers
    one = init_kv_cache(batch, max_len, cfg.num_kv_heads, cfg.head_dim,
                        dtype=dtype, device=device)
    cross = (L, batch, ef, cfg.num_kv_heads, cfg.head_dim)
    return {
        "self": tree_map(lambda a: a[None].repeat((L,) + (1,) * a.dim()),
                         one),
        "cross_k": torch.zeros(cross, dtype=dtype, device=device),
        "cross_v": torch.zeros(cross, dtype=dtype, device=device),
    }


def prefill_cross(params, enc_states, state, cfg: WhisperConfig):
    """Each decoder layer's cross-attention K / V of ``enc_states`` (B,
    Sf, d), in the state's dtype; returns the state with them."""
    enc = enc_states.to(cfg.cdtype())
    ks, vs = [], []
    for i in range(cfg.num_layers):
        ap = _cast(_layer(params["dec_layers"], i)["cross_attn"], cfg)
        k, v = _cross_kv(ap, enc, cfg)
        ks.append(k.to(state["cross_k"].dtype))
        vs.append(v.to(state["cross_v"].dtype))
    return dict(state, cross_k=torch.stack(ks), cross_v=torch.stack(vs))


def decode_step(params, state, tokens, cfg: WhisperConfig, *, cur_pos):
    """One decoder token. tokens: (B, 1); cur_pos: an int below the learned
    positions (else ``ValueError``). Writes the self-attention caches in
    place and returns (logits (B, 1, V) f32, state)."""
    cur_pos = int(cur_pos)
    _check_positions(params, cur_pos, cfg)
    pos = torch.full((tokens.shape[0], 1), cur_pos, dtype=torch.int32,
                     device=tokens.device)
    x = embedding_apply(params["embed"], tokens, compute_dtype=cfg.cdtype())
    x = x + embedding_apply(params["pos_embed"], pos,
                            compute_dtype=cfg.cdtype())
    for i in range(cfg.num_layers):
        lp = _cast(_layer(params["dec_layers"], i), cfg)
        cache = {k: a[i] for k, a in state["self"].items()}
        d, _ = attention_decode(lp["self_attn"], _ln(lp["self_norm"], x, cfg),
                                _attn_cfg(cfg), cache=cache, cur_pos=cur_pos)
        x = x + d.to(x.dtype)
        kv = (state["cross_k"][i], state["cross_v"][i], None)
        x = x + attention_apply(lp["cross_attn"],
                                _ln(lp["cross_norm"], x, cfg),
                                _attn_cfg(cfg), positions=pos,
                                kv_override=kv).to(x.dtype)
        x = x + mlp_apply(lp["mlp"], _ln(lp["mlp_norm"], x, cfg), act="gelu")
    x = _ln(params["dec_norm"], x, cfg)
    return unembed(params, x, cfg).float(), state
