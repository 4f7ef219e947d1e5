"""Rotary position embeddings (RoPE), in f32.

Qwen2-VL's M-RoPE (``apply_mrope``) belongs to the VLM slice and is not
ported yet; ``nn.attention`` raises for a config that asks for it.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim, *, theta=10000.0, device=None):
    """Inverse frequencies, shape (head_dim // 2,) f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def _rotate(x, angles):
    """x: (..., head_dim); angles broadcastable to (..., head_dim // 2).
    Rotates the two halves of the last axis in f32, returns ``x.dtype``."""
    x32 = x.float()
    x1, x2 = x32.chunk(2, dim=-1)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x, positions, *, theta=10000.0):
    """x: (B, S, H, D); positions: (B, S) int."""
    inv = rope_freqs(x.shape[-1], theta=theta, device=x.device)
    ang = positions.float()[..., None] * inv               # (B, S, D/2)
    return _rotate(x, ang[:, :, None, :])                  # over heads
