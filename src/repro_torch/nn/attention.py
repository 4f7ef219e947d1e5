"""Grouped-query attention with RoPE or M-RoPE, qk-norm, sliding windows
and a ring-buffer KV cache.

Two execution paths, selected by ``AttnConfig.impl``:
  * ``xla``    — the plain chunked online softmax in PyTorch (the JAX
                 package's ``xla`` path);
  * ``kernel`` — the flash-attention kernel (K7), the counterpart of the
                 JAX package's ``pallas`` / ``pallas_interpret``. Like the
                 JAX kernel path it ignores ``positions`` for the mask and
                 assumes aligned positions 0..S-1.

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

from repro_torch.nn.init import lecun_normal
from repro_torch.nn.linear import dense_init, dense_apply
from repro_torch.nn.norm import rmsnorm_init, rmsnorm_apply
from repro_torch.nn.rope import apply_mrope, apply_rope

NEG_INF = -2.3819763e38  # large negative, bf16-safe masking
IMPLS = ("xla", "kernel")


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
    q = dense_apply(params["wq"], x).reshape(B, S, H, D)
    k = dense_apply(params["wk"], x).reshape(B, S, K, D)
    v = dense_apply(params["wv"], x).reshape(B, S, K, D)
    if cfg.qk_norm:
        q = rmsnorm_apply(params["q_norm"], q)
        k = rmsnorm_apply(params["k_norm"], k)
    if cfg.use_rope and cfg.mrope_sections is not None:
        q = apply_mrope(q, positions, theta=cfg.rope_theta,
                        sections=cfg.mrope_sections)
        k = apply_mrope(k, positions, theta=cfg.rope_theta,
                        sections=cfg.mrope_sections)
    elif cfg.use_rope:
        q = apply_rope(q, positions, theta=cfg.rope_theta)
        k = apply_rope(k, positions, theta=cfg.rope_theta)
    return q, k, v


def _xla_attention(q, k, v, scale, *, q_pos=None, kv_pos=None, causal=True,
                   window=None, kv_valid=None, kv_chunk=4096):
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
        s = torch.einsum("bqkgd,bskd->bkgqs", q5,
                         k[:, lo:hi].float()) * scale
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
        q = dense_apply(params["wq"], x).reshape(B, S, H, D)
        if cfg.qk_norm:
            q = rmsnorm_apply(params["q_norm"], q)
        k, v, kv_mask = kv_override
        out = _xla_attention(q, k, v, scale, causal=False, kv_valid=kv_mask,
                             kv_chunk=cfg.kv_chunk)
        return dense_apply(params["wo"], out.reshape(B, S, -1))

    q, k, v = _project_qkv(params, x, cfg, positions)
    if cfg.impl == "kernel":
        from repro_torch.kernels.flash_attention import ops as flash_ops
        out = flash_ops.flash_attention(q, k, v, causal=causal,
                                        window=cfg.sliding_window)
    elif cfg.impl == "xla":
        pq = positions if positions.dim() == 2 else positions[0]
        out = _xla_attention(q, k, v, scale, q_pos=pq, kv_pos=pq,
                             causal=causal,
                             window=cfg.sliding_window, kv_chunk=cfg.kv_chunk)
    else:
        raise ValueError(f"attention impl {cfg.impl!r} is not one of {IMPLS}")
    out = dense_apply(params["wo"], out.reshape(B, S, -1))
    if return_kv:
        return out, (k, v)
    return out


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
    rows = torch.arange(B, device=dev)
    quantized = cache["k"].dtype == torch.int8
    if quantized:
        (k_store, k_sc), (v_store, v_sc) = (_quantize_kv(k_new),
                                            _quantize_kv(v_new))
        cache["k_scale"][rows, slot] = k_sc[:, 0]
        cache["v_scale"][rows, slot] = v_sc[:, 0]
    else:
        k_store, v_store = k_new, v_new
    cache["k"][rows, slot] = k_store[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v_store[:, 0].to(cache["v"].dtype)
    cache["pos"][rows, slot] = pos_arr[:, 0]
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
    out = _xla_attention(q, k, v, scale, kv_valid=valid,
                         kv_chunk=cfg.kv_chunk)
    out = dense_apply(params["wo"], out.reshape(B, 1, -1))
    return out, cache
