"""Shared model pieces: the compute policy, the loss and accuracy."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

IGNORE_LABEL = -100


@dataclasses.dataclass(frozen=True)
class ComputePolicy:
    """Mixed-precision policy for the split-model compute path.

    ``compute_dtype`` sets the conv/matmul/elementwise dtype of the client
    forward and the server forward-backward. Master params, the BatchNorm
    statistics (batch and running) and the loss stay f32. With a non-f32
    compute dtype the smashed data crosses the collector in that dtype.

    ``use_fused_kernels`` gates the fused ``bn_act`` and ``softmax_xent``
    kernels; ``None`` means on when CUDA is present. The wrappers run their
    plain versions for tensors on the CPU either way.
    """
    compute_dtype: str = "float32"
    use_fused_kernels: Optional[bool] = None

    def cdtype(self):
        return getattr(torch, self.compute_dtype)

    @property
    def mixed(self) -> bool:
        return self.cdtype() != torch.float32

    def cast(self, x):
        """Cast an activation into the compute dtype (no-op at f32)."""
        return x.to(self.cdtype()) if self.mixed else x

    def fused(self) -> bool:
        if self.use_fused_kernels is None:
            return torch.cuda.is_available()
        return bool(self.use_fused_kernels)


def valid_count(valid, reduce=None):
    """``max(#valid, 1)``, the loss's denominator; with ``reduce`` (a sum
    over ranks) the count of every rank's rows."""
    if reduce is None:
        return valid.sum().clamp_min(1)
    return reduce(valid.sum().to(torch.float32)).clamp_min(1)


def softmax_cross_entropy(logits, labels, *, ignore=IGNORE_LABEL,
                          reduce=None):
    """logits (..., V); labels (...,) int. Mean over non-ignored rows, with
    ``max(#valid, 1)`` in the denominator: all-ignored gives 0, where
    ``F.cross_entropy`` gives NaN. With ``reduce`` the rows are one rank's
    share of a batch split over ranks: the sum is local and the count
    global, so the ranks' losses sum to the global mean."""
    logits = logits.float()
    labels = labels.long()
    valid = labels != ignore
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, lse - ll, torch.zeros_like(lse))
    return loss.sum() / valid_count(valid, reduce)


def accuracy_from_logits(logits, labels, *, ignore=IGNORE_LABEL):
    labels = labels.long()
    valid = labels != ignore
    hit = (logits.argmax(dim=-1) == labels) & valid
    return hit.sum() / valid.sum().clamp_min(1)
