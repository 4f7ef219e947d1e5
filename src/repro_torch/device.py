"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None):
    """``None`` means the card (``"cuda"``) and raises when CUDA is absent:
    the port never falls back to the CPU on its own. Pass ``"cpu"`` to run
    on the CPU on purpose."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on the GPU by "
                "default; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)
