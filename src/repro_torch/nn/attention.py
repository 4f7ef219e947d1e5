"""Grouped-query attention with RoPE or M-RoPE, qk-norm, sliding windows
and a ring-buffer KV cache.

Three execution paths, selected by ``AttnConfig.impl``:
  * ``xla``    — the plain chunked online softmax in PyTorch (the JAX
                 package's ``xla`` path);
  * ``kernel`` — the flash-attention kernel (K7), the counterpart of the
                 JAX package's ``pallas`` / ``pallas_interpret``. Like the
                 JAX kernel path it ignores ``positions`` for the mask and
                 assumes aligned positions 0..S-1;
  * ``flex``   — training attention on the card: PyTorch's
                 ``flex_attention``, compiled, with its own backward and a
                 causal (and windowed) block mask built once per (S,
                 window), so a windowed layer skips the blocks outside its
                 window. It too assumes aligned positions 0..S-1.

The attention core of every path runs inside the ``attn.core`` span.
``out_gate`` (afmoe) multiplies the core's output by ``sigmoid(x @
w_gate)`` before ``wo``.

Under M-RoPE (``mrope_sections``, qwen2-vl) positions are (3, B, S) and
the ``xla`` path masks by the temporal ids ``positions[0]``, as the JAX
package's does: the vision tokens share one temporal id, so there they
attend to each other both ways, while the kernel path stays causal by
index. The two paths differ in the JAX package alike.

Decode uses a slot-indexed cache: ``cache["pos"]`` records the absolute
position held in each slot (-1 = empty). Global attention uses a cache of
``max_len`` slots; sliding-window attention uses ``window`` slots written
round-robin. Unlike the JAX package, :func:`attention_decode` writes the
new token into the cache tensors in place (and returns them): a
functional update would copy every layer's whole cache on every token.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.sharding.dtensor import (apply_spec, dims_spec,
                                          gather_rows, is_dtensor,
                                          local_region, split_last)
from repro_torch.nn.init import lecun_normal
from repro_torch.nn.linear import dense_init, dense_apply
from repro_torch.nn.norm import rmsnorm_init, rmsnorm_apply
from repro_torch.nn.rope import apply_mrope, apply_rope
from repro_torch.trace import span

NEG_INF = -2.3819763e38  # large negative, bf16-safe masking
# chunked scores (B, K, G, Sq, ck): batch over dp, Sq over "model"
SCORE_ROLES = ("dp", None, None, "tp", None)
IMPLS = ("xla", "kernel", "flex")


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    use_bias: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None
    sliding_window: Optional[int] = None  # None = global attention
    use_rope: bool = True
    out_gate: bool = False
    norm_eps: float = 1e-6      # the qk-norm's
    impl: str = "xla"
    kv_chunk: int = 4096        # online-softmax chunk of the xla path
    mesh_axes: Optional[Tuple[Tuple[str, int], ...]] = None

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads


def attention_init(gen, cfg: AttnConfig, *, dtype=torch.float32):
    H, K, D, M = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "wq": dense_init(gen, M, H * D, use_bias=cfg.use_bias, dtype=dtype),
        "wk": dense_init(gen, M, K * D, use_bias=cfg.use_bias, dtype=dtype),
        "wv": dense_init(gen, M, K * D, use_bias=cfg.use_bias, dtype=dtype),
        "wo": dense_init(gen, H * D, M, use_bias=False, dtype=dtype,
                         init=lecun_normal),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(gen, D, dtype=dtype)
        p["k_norm"] = rmsnorm_init(gen, D, dtype=dtype)
    if cfg.out_gate:
        p["wgate"] = dense_init(gen, M, H * D, use_bias=False, dtype=dtype)
    return p


def init_kv_cache(batch, num_slots, num_kv_heads, head_dim, *,
                  dtype=torch.bfloat16, device=None):
    """num_slots = max_len for global layers, window for SWA layers.

    ``dtype=torch.int8`` selects the quantized cache: int8 values with
    per-(slot, head) fp16 scales, quantized at write and dequantized at
    read inside :func:`attention_decode`."""
    shape = (batch, num_slots, num_kv_heads, head_dim)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, num_slots), -1, dtype=torch.int32,
                          device=device),
    }
    if dtype == torch.int8:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:3], dtype=torch.float16,
                                      device=device)
    return cache


def _quantize_kv(x):
    """x: (B, 1, K, D) -> (int8 values, fp16 scales (B, 1, K))."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp_min(amax / 127.0, 1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _dequantize_kv(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale.float()[..., None]).to(dtype)


def _project_qkv(params, x, cfg: AttnConfig, positions):
    """q (B, S, H, D), k and v (B, S, K, D), rotated by ``positions``:
    (B, S), or (3, B, S) with M-RoPE."""
    B, S, _ = x.shape
    H, K, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = gather_rows(x)              # once for the three projections
    q = split_last(dense_apply(params["wq"], x), H, D)
    k = split_last(dense_apply(params["wk"], x), K, D)
    v = split_last(dense_apply(params["wv"], x), K, D)
    if cfg.qk_norm:
        q = rmsnorm_apply(params["q_norm"], q, eps=cfg.norm_eps)
        k = rmsnorm_apply(params["k_norm"], k, eps=cfg.norm_eps)
    if cfg.use_rope and cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, theta=cfg.rope_theta,
                        sections=cfg.mrope_sections)
        k = apply_mrope(k, positions, theta=cfg.rope_theta,
                        sections=cfg.mrope_sections)
    elif cfg.use_rope:
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _constrain_scores(s, mesh_axes):
    """Chunked scores (B, K, G, Sq, ck): batch over dp, Sq over "model"
    (sequence-parallel attention) where divisible. The identity without
    ``mesh_axes`` or on a plain tensor."""
    if not mesh_axes:
        return s
    return apply_spec(s, mesh_axes, dims_spec(s.shape, mesh_axes,
                                              SCORE_ROLES))


def _xla_attention(q, k, v, scale, *, q_pos=None, kv_pos=None, causal=True,
                   window=None, kv_valid=None, kv_chunk=4096,
                   mesh_axes=None):
    """The chunked online softmax below; under ``mesh_axes`` with DTensor
    inputs it runs on each device's shards in the layout that
    :func:`_constrain_scores` gives the scores: the batch over dp, the
    queries' sequence over "model" where they divide, the keys and
    values whole along the sequence. The chunk loop is then local work
    (DTensor has no cheap rule for the scores' reshapes)."""
    if not mesh_axes:
        return _attention_chunks(q, k, v, scale, q_pos=q_pos, kv_pos=kv_pos,
                                 causal=causal, window=window,
                                 kv_valid=kv_valid, kv_chunk=kv_chunk)
    dp, sq = dims_spec(q.shape[:2], mesh_axes, ("dp", "tp"))
    q_spec, kv_spec = (dp, sq, None, None), (dp, None, None, None)
    return local_region(
        lambda q_, k_, v_, qp, kp, kvv: _attention_chunks(
            q_, k_, v_, scale, q_pos=qp, kv_pos=kp, causal=causal,
            window=window, kv_valid=kvv, kv_chunk=kv_chunk,
            mesh_axes=mesh_axes),
        mesh_axes, [q_spec, kv_spec, kv_spec, (dp, sq), (dp, None),
                    (dp, None)], q_spec,
        # each device's queries read every key: sum the keys' gradients
        partial_grads=(1, 2) if sq else ())(q, k, v, q_pos, kv_pos,
                                            kv_valid)


def _attention_chunks(q, k, v, scale, *, q_pos=None, kv_pos=None,
                      causal=True, window=None, kv_valid=None, kv_chunk=4096,
                      mesh_axes=None):
    """Chunked online-softmax attention (never materializes Sq x Skv).

    q: (B, Sq, H, D); k/v: (B, Skv, K, D). The mask is composed per kv
    chunk from q_pos/kv_pos (B, S*) absolute positions (causal and window
    deltas) and kv_valid (B, Skv) (cache slots, cross-attention padding).
    Scores, max, sum and accumulator are f32; ``p`` is cast to ``v``'s
    dtype before the PV product, whose products and sums are f32 (JAX's
    ``preferred_element_type``)."""
    B, Sq, H, D = q.shape
    K, Skv = k.shape[2], k.shape[1]
    G = H // K
    q5 = q.reshape(B, Sq, K, G, D).float()
    ck = min(kv_chunk, Skv)
    dev = q.device
    m = torch.full((B, K, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, K, G, Sq, D), dtype=torch.float32, device=dev)
    for lo in range(0, Skv, ck):
        hi = min(lo + ck, Skv)
        s = _constrain_scores(torch.einsum(
            "bqkgd,bskd->bkgqs", q5, k[:, lo:hi].float()) * scale, mesh_axes)
        mask = None
        if q_pos is not None and kv_pos is not None:
            delta = q_pos[:, :, None] - kv_pos[:, None, lo:hi]   # (B,Sq,ck)
            dm = (delta >= 0) if causal else torch.ones_like(
                delta, dtype=torch.bool)
            if window is not None:
                dm = dm & (delta < window)
            mask = dm[:, None, None]
        if kv_valid is not None:
            kvm = kv_valid[:, None, None, None, lo:hi]
            mask = kvm if mask is None else mask & kvm
        if mask is not None:
            s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), v[:, lo:hi].float())
        m = m_new
    l = torch.where(l == 0.0, torch.ones((), device=dev), l)
    out = (acc / l[..., None]).to(q.dtype)                  # (B,K,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


_FLEX = {}


def _flex_block_mask(seq, window, device):
    """The block mask of causal attention over ``seq`` aligned positions,
    and of ``window`` keys back where given; one per (seq, window,
    device)."""
    key = ("mask", seq, window, str(device))
    if key not in _FLEX:
        from torch.nn.attention.flex_attention import create_block_mask

        if window is None:
            def mask_mod(b, h, q, kv):
                return q >= kv
        else:
            def mask_mod(b, h, q, kv):
                return (q >= kv) & (q - kv < window)
        _FLEX[key] = create_block_mask(mask_mod, None, None, seq, seq,
                                       device=device)
    return _FLEX[key]


def _flex_attention(q, k, v, scale, window):
    """q (B, S, H, D), k / v (B, S, K, D) -> (B, S, H, D) through the
    compiled ``flex_attention`` (GQA by ``enable_gqa``)."""
    if "fn" not in _FLEX:
        from torch.nn.attention.flex_attention import flex_attention
        _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
    mask = _flex_block_mask(q.shape[1], window, q.device)
    out = _FLEX["fn"](q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), block_mask=mask, scale=scale,
                      enable_gqa=q.shape[2] != k.shape[2])
    return out.transpose(1, 2)


def _kernel_specs(cfg: AttnConfig, batch):
    """(in specs, out spec) of the kernel path under ``mesh_axes``: the
    batch over dp and the heads over "model" where both the q and kv
    heads divide; the sequence whole (causal attention needs every key)."""
    if not cfg.mesh_axes:
        return [None] * 3, None
    dp, hq, hk = dims_spec((batch, cfg.num_heads, cfg.num_kv_heads),
                           cfg.mesh_axes, ("dp", "tp", "tp"))
    spec = (dp, None, hq if hk else None, None)
    return [spec] * 3, spec


def attention_apply(params, x, cfg: AttnConfig, *, positions,
                    causal: bool = True, return_kv: bool = False,
                    kv_override=None):
    """Full-sequence (prefill) attention.

    ``kv_override=(k, v, kv_mask)`` is cross-attention: q from ``x``, fixed
    k/v, a boolean kv_mask (B, Skv) or None, on the plain path. Returns
    ``out`` or ``(out, (k, v))`` when ``return_kv``."""
    B, S, _ = x.shape
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if kv_override is not None:
        H, D = cfg.num_heads, cfg.head_dim
        q = split_last(dense_apply(params["wq"], x), H, D)
        if cfg.qk_norm:
            q = rmsnorm_apply(params["q_norm"], q)
        k, v, kv_mask = kv_override
        with span("attn.core"):
            out = _xla_attention(q, k, v, scale, causal=False,
                                 kv_valid=kv_mask, kv_chunk=cfg.kv_chunk,
                                 mesh_axes=cfg.mesh_axes)
        return dense_apply(params["wo"], out.reshape(B, S, -1))

    q, k, v = _project_qkv(params, x, cfg, positions)
    if cfg.impl not in IMPLS:
        raise ValueError(f"attention impl {cfg.impl!r} is not one of {IMPLS}")
    with span("attn.core"):
        if cfg.impl == "kernel":
            from repro_torch.kernels.flash_attention import ops as flash_ops
            out = local_region(
                lambda q_, k_, v_: flash_ops.flash_attention(
                    q_, k_, v_, causal=causal, window=cfg.sliding_window),
                cfg.mesh_axes, *_kernel_specs(cfg, B))(q, k, v)
        elif cfg.impl == "flex":
            if not causal or cfg.mesh_axes:
                raise ValueError("the flex path is causal self-attention "
                                 "on plain tensors")
            out = _flex_attention(q, k, v, scale, cfg.sliding_window)
        else:
            pq = positions if positions.dim() == 2 else positions[0]
            out = _xla_attention(q, k, v, scale, q_pos=pq, kv_pos=pq,
                                 causal=causal, window=cfg.sliding_window,
                                 kv_chunk=cfg.kv_chunk,
                                 mesh_axes=cfg.mesh_axes)
    out = out.reshape(B, S, -1)
    if cfg.out_gate:
        out = out * torch.sigmoid(dense_apply(params["wgate"], x))
    out = dense_apply(params["wo"], out)
    if return_kv:
        return out, (k, v)
    return out


def _write_slot(dst, rows, slot, val):
    """``dst[rows, slot] = val`` in place (``rows`` is ``arange(B)``). A
    DTensor cache is written through a slot mask (an elementwise select,
    which every layout of the cache supports) and copied back into its
    own placements; it needs no ``rows``."""
    if not is_dtensor(dst):
        dst[rows, slot] = val.to(dst.dtype)
        return
    hit = torch.arange(dst.shape[1], device=slot.device) == slot[:, None]
    hit = hit.reshape(hit.shape + (1,) * (dst.dim() - 2))
    new = torch.where(hit, val[:, None].to(dst.dtype), dst)
    dst.copy_(new.redistribute(dst.device_mesh, dst.placements))


def attention_decode(params, x, cfg: AttnConfig, *, cache, cur_pos):
    """One-token decode. x: (B, 1, d_model); cur_pos: an int (every row at
    that position) or a (B,) int tensor of per-request positions
    (continuous batching). Writes the token's k/v into ``cache`` in place
    and returns ``(out, cache)``."""
    B = x.shape[0]
    dev = x.device
    num_slots = cache["k"].shape[1]
    if torch.is_tensor(cur_pos) and cur_pos.dim() == 1:
        pos_arr = cur_pos.to(device=dev, dtype=torch.int32)[:, None]
    else:
        pos_arr = torch.full((B, 1), int(cur_pos), dtype=torch.int32,
                             device=dev)
    positions = (pos_arr[None].expand(3, B, 1)
                 if cfg.mrope_sections is not None else pos_arr)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)

    slot = torch.remainder(pos_arr[:, 0], num_slots).long()  # ring/identity
    rows = None if is_dtensor(cache["k"]) else torch.arange(B, device=dev)
    quantized = cache["k"].dtype == torch.int8
    if quantized:
        (k_store, k_sc), (v_store, v_sc) = (_quantize_kv(k_new),
                                            _quantize_kv(v_new))
        _write_slot(cache["k_scale"], rows, slot, k_sc[:, 0])
        _write_slot(cache["v_scale"], rows, slot, v_sc[:, 0])
    else:
        k_store, v_store = k_new, v_new
    _write_slot(cache["k"], rows, slot, k_store[:, 0])
    _write_slot(cache["v"], rows, slot, v_store[:, 0])
    _write_slot(cache["pos"], rows, slot, pos_arr[:, 0])
    pos = cache["pos"]

    if quantized:
        k = _dequantize_kv(cache["k"], cache["k_scale"])
        v = _dequantize_kv(cache["v"], cache["v_scale"])
    else:
        k, v = cache["k"], cache["v"]
    valid = (pos >= 0) & (pos <= pos_arr)
    if cfg.sliding_window is not None:
        valid = valid & (pos_arr - pos < cfg.sliding_window)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    with span("attn.core"):
        out = _xla_attention(q, k, v, scale, kv_valid=valid,
                             kv_chunk=cfg.kv_chunk, mesh_axes=cfg.mesh_axes)
    out = out.reshape(B, 1, -1)
    if cfg.out_gate:
        out = out * torch.sigmoid(dense_apply(params["wgate"], x))
    out = dense_apply(params["wo"], out)
    return out, cache
