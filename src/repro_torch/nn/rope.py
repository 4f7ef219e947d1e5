"""Rotary position embeddings, in f32: standard RoPE and Qwen2-VL's
M-RoPE.

M-RoPE (multimodal RoPE, arXiv:2409.12191): the head_dim channels are split
into three sections (temporal, height, width); each section rotates with
its own position id. For text tokens the three ids are equal, which is 1-D
RoPE.
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


def mrope_positions(positions_3d):
    """Identity helper kept for API symmetry; positions_3d: (3, B, S)."""
    return positions_3d


def apply_mrope(x, positions_3d, *, theta=1000000.0, sections=(16, 24, 24)):
    """x: (B, S, H, D); positions_3d: (3, B, S) int (t, h, w ids).

    ``sections`` are the half-dim channel counts of (t, h, w) and sum to
    D/2. Each channel's angle is its section's position times its inverse
    frequency, the same f32 product the JAX package's one-hot select
    keeps; the select is an index here, so no matmul (nor TF32) touches
    it."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    inv = rope_freqs(x.shape[-1], theta=theta, device=x.device)   # (D/2,)
    # each channel's section, 0,0,..,1,1,..,2,2..: formed on the device
    # (a host list copied over, or repeat_interleave's sizing, would stall
    # the host on the card once a call)
    c = torch.arange(half, device=x.device)
    sec_id = ((c >= sections[0]).long()
              + (c >= sections[0] + sections[1]).long())
    pos = positions_3d.float()[sec_id]                  # (D/2, B, S)
    ang = pos.permute(1, 2, 0) * inv                    # (B, S, D/2)
    return _rotate(x, ang[:, :, None, :])
