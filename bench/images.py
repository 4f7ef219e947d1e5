"""Synthetic class-conditional CIFAR images, made on the device from a seed.

A copy of the construction of ``repro_torch.data.synthetic`` (itself the
JAX package's generator): each class has a smooth random template (a
coarse 6 x 6 normal grid, bilinearly upsampled, unit std); a sample is its
class template plus Gaussian noise of std 0.35, rolled by a random shift of
up to a tenth of the image along each axis. Drawn here in a few large calls
with a ``torch.Generator`` on the device, already in the positive-label
layout (client ``k`` holds only class ``k``), so set-up copies nothing from
the host.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NOISE = 0.35
COARSE = 6


def positive_label_cifar(gen, clients, per_client, hw=32, channels=3):
    """``{"x": (clients, per_client, hw, hw, channels) f32, "y": (clients,
    per_client) int64}`` on ``gen``'s device, client ``k`` holding class
    ``k`` only."""
    dev = gen.device
    coarse = torch.randn((clients, channels, COARSE, COARSE), generator=gen,
                         device=dev)
    tmpl = F.interpolate(coarse, size=(hw, hw), mode="bilinear",
                         align_corners=False)
    tmpl = tmpl / (tmpl.std(dim=(1, 2, 3), correction=0, keepdim=True)
                   + 1e-6)
    tmpl = tmpl.permute(0, 2, 3, 1)                        # (C, H, W, ch)
    x = torch.randn((clients, per_client, hw, hw, channels), generator=gen,
                    device=dev)
    x.mul_(NOISE).add_(tmpl[:, None])
    max_roll = max(1, hw // 10)
    rolls = torch.randint(-max_roll, max_roll + 1, (clients, per_client, 2),
                          generator=gen, device=dev)
    ar = torch.arange(hw, device=dev)
    ih = (ar - rolls[..., :1]) % hw                        # (C, n, H)
    iw = (ar - rolls[..., 1:]) % hw                        # (C, n, W)
    c = torch.arange(clients, device=dev)[:, None, None, None]
    j = torch.arange(per_client, device=dev)[None, :, None, None]
    x = x[c, j, ih[..., :, None], iw[..., None, :]]
    y = torch.arange(clients, device=dev)[:, None].expand(
        clients, per_client).contiguous()
    return {"x": x, "y": y}
