"""Synthetic class-conditional CIFAR-like images + the paper's partitioners.

The same construction as the JAX package's generator, driven by a
``torch.Generator`` (the draws differ, the distributions match): each class
gets a smooth random template (a coarse normal grid, bilinearly
upsampled, unit std); a sample is its class template plus Gaussian noise,
rolled by a random shift. Data is drawn on the CPU and moved to
``device`` in bulk.

  * ``partition_positive_labels``: client k receives ONLY class k;
  * ``partition_iid``: shuffled equal shards.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _smooth(gen, shape, cutoff=6):
    """Low-frequency random image: coarse grid, bilinear-upsampled."""
    h, w, c = shape
    coarse = torch.randn((cutoff, cutoff, c), generator=gen)
    img = F.interpolate(coarse.permute(2, 0, 1)[None], size=(h, w),
                        mode="bilinear", align_corners=False)[0]
    img = img.permute(1, 2, 0)
    return img / (img.std(correction=0) + 1e-6)


def _roll_each(x, rolls):
    """Roll every image ``x[i]`` (H, W, C) by ``rolls[i]`` along H and W."""
    n, h, w, _ = x.shape
    ih = (torch.arange(h)[None, :] - rolls[:, :1]) % h
    iw = (torch.arange(w)[None, :] - rolls[:, 1:]) % w
    return x[torch.arange(n)[:, None, None], ih[:, :, None], iw[:, None, :]]


def make_synthetic_cifar(gen, *, num_classes=10, train_per_class=200,
                         test_per_class=50, hw=32, noise=0.35, device="cpu"):
    """Returns (train_x, train_y, test_x, test_y); images (N, hw, hw, 3)
    f32, labels int64, on ``device``."""
    templates = torch.stack([_smooth(gen, (hw, hw, 3))
                             for _ in range(num_classes)])

    def make(per_class):
        n = num_classes * per_class
        y = torch.arange(num_classes).repeat_interleave(per_class)
        eps = torch.randn((n, hw, hw, 3), generator=gen) * noise
        max_roll = max(1, hw // 10)      # shift scales with image size
        rolls = torch.randint(-max_roll, max_roll + 1, (n, 2), generator=gen)
        x = _roll_each(templates[y] + eps, rolls)
        return x.float().to(device), y.to(device)

    train_x, train_y = make(train_per_class)
    test_x, test_y = make(test_per_class)
    return train_x, train_y, test_x, test_y


def partition_positive_labels(x, y, num_classes):
    """Client k gets exactly class k: {"x": (N, n, ...), "y": (N, n)}."""
    n_min = min(int((y == k).sum()) for k in range(num_classes))
    idx = [torch.nonzero(y == k)[:n_min, 0] for k in range(num_classes)]
    return {"x": torch.stack([x[i] for i in idx]),
            "y": torch.stack([y[i] for i in idx])}


def partition_iid(gen, x, y, num_clients):
    """Shuffle, then split into equal shards (the paper's IID control)."""
    n = x.shape[0]
    per = n // num_clients
    perm = torch.randperm(n, generator=gen)[:per * num_clients].to(x.device)
    return {"x": x[perm].reshape((num_clients, per) + tuple(x.shape[1:])),
            "y": y[perm].reshape(num_clients, per)}
