"""Training-time augmentations of the paper: random horizontal flip and
random crop with reflection padding, and per-channel normalisation (the
paper's mild rotation is left out, as in the JAX package)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def flip_crop(x, flip, offsets, *, pad=4):
    """The augmentation for given draws: flip image ``i`` of ``x`` (B, H,
    W, C) left-right where ``flip[i]``, reflect-pad by ``pad`` and crop
    the (H, W) window at ``offsets[i]`` = (row, column) in ``[0, 2*pad]``."""
    B, H, W, _ = x.shape
    flip = flip.to(device=x.device, dtype=torch.bool)
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad),
               mode="reflect").permute(0, 2, 3, 1)
    offsets = offsets.to(device=x.device, dtype=torch.long)
    rows = offsets[:, :1] + torch.arange(H, device=x.device)
    cols = offsets[:, 1:] + torch.arange(W, device=x.device)
    return xp[torch.arange(B, device=x.device)[:, None, None],
              rows[:, :, None], cols[:, None, :]]


def augment_batch(gen, x, *, pad=4):
    """Random horizontal flip + random crop with reflection padding, the
    draws taken from ``gen`` (a CPU ``torch.Generator``). x: (B, H, W,
    C)."""
    B = x.shape[0]
    flip = torch.rand(B, generator=gen) < 0.5
    offsets = torch.randint(0, 2 * pad + 1, (B, 2), generator=gen)
    return flip_crop(x, flip, offsets, pad=pad)


def normalize(x, mean, std):
    return (x - torch.as_tensor(mean, dtype=x.dtype, device=x.device)) / \
        torch.as_tensor(std, dtype=x.dtype, device=x.device)
