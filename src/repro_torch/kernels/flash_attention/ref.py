"""Plain PyTorch version of the flash-attention kernel: the full softmax."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.3819763e38


def attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, Sq, H, D); k/v: (B, Skv, K, D) with H % K == 0.

    Positions are 0..S-1 on both sides (q and kv aligned). Scores,
    softmax and the PV product in f32; returns (B, Sq, H, D) in q.dtype."""
    B, Sq, H, D = q.shape
    K, Skv = k.shape[2], k.shape[1]
    G = H // K
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qf = q.reshape(B, Sq, K, G, D).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    delta = (torch.arange(Sq, device=q.device)[:, None]
             - torch.arange(Skv, device=q.device)[None, :])
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (delta >= 0)
    if window is not None:
        mask = mask & (delta < window)
    scores = torch.where(mask, scores, torch.full((), NEG_INF,
                                                  device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)
