"""Shared model pieces: the compute policy, the losses and accuracy, the
transformer config, rematerialisation, and the sharding constraints
(identities on one device)."""
from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.tree import tree_leaves

logger = logging.getLogger(__name__)

IGNORE_LABEL = -100

# Read once at import time (an explicit keyword default), not inside the
# loss body, as the JAX package does.
DEFAULT_CE_CHUNKS = int(os.environ.get("REPRO_CE_CHUNKS", "8"))


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


def chunked_lm_loss(hidden, labels, unembed_fn, *, chunks=DEFAULT_CE_CHUNKS,
                    ignore=IGNORE_LABEL):
    """Cross-entropy over a large vocab without holding the full logits.

    ``hidden``: (B, S, d) final-norm output; ``unembed_fn(x) -> logits``.
    The sequence axis is split into ``chunks`` (default
    ``DEFAULT_CE_CHUNKS``, the ``REPRO_CE_CHUNKS`` env value at import
    time; reduced to the largest divisor of S at most ``chunks``, with a
    warning); each chunk's logits and loss run under
    ``torch.utils.checkpoint``, so the backward recomputes one chunk's
    logits at a time — peak logits memory drops by ~``chunks``x. Mean
    over the non-ignored labels.
    """
    if chunks is None:
        chunks = DEFAULT_CE_CHUNKS
    B, S, d = hidden.shape
    requested = chunks
    while chunks > 1 and S % chunks != 0:
        chunks -= 1
    if chunks != requested:
        logger.warning(
            "chunked_lm_loss: seq len %d not divisible by chunks=%d; "
            "reduced to %d", S, requested, chunks)

    def one(xc, lc):
        logits = unembed_fn(xc).float()
        valid = lc != ignore
        safe = torch.where(valid, lc, torch.zeros_like(lc))
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, safe[..., None])[..., 0]
        loss = torch.where(valid, lse - ll, torch.zeros_like(lse))
        return loss.sum(), valid.sum()

    labels = labels.long()
    Sc = S // chunks
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for i in range(chunks):
        t, c = checkpoint(one, hidden[:, i * Sc:(i + 1) * Sc],
                          labels[:, i * Sc:(i + 1) * Sc],
                          use_reentrant=False)
        total = total + t
        count = count + c
    return total / count.clamp_min(1)


def accuracy_from_logits(logits, labels, *, ignore=IGNORE_LABEL):
    labels = labels.long()
    valid = labels != ignore
    hit = (logits.argmax(dim=-1) == labels) & valid
    return hit.sum() / valid.sum().clamp_min(1)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """One config covers dense / GQA / MoE / VLM decoder variants; this
    slice of the port runs the dense ones (MoE layers and the VLM stub
    frontend raise)."""
    name: str = "transformer"
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1024
    act: str = "silu"                       # "gelu" -> GeGLU
    qk_norm: bool = False
    attn_bias: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl
    norm_eps: float = 1e-6
    norm_scale_offset: float = 0.0          # gemma: 1.0 ((1 + scale))
    embed_scale: bool = False               # gemma: x *= sqrt(d_model)
    tie_embeddings: bool = True
    logit_softcap: float = 0.0              # 0 = off
    # MoE
    num_experts: int = 0
    d_ff_dense: int = 0                     # dense-layer MLP width; 0 = d_ff
    moe_layer_period: int = 1
    moe_shared_expert: bool = True
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # attention pattern (llama4 iRoPE: 3 local chunked + 1 global)
    sliding_window: Optional[int] = None
    global_attn_period: int = 0             # 0 = all layers same window
    # execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attention_impl: str = "xla"             # "xla" | "kernel" (K7)
    remat: bool = True
    scan_layers: bool = True
    mesh_axes: Optional[Tuple[Tuple[str, int], ...]] = None
    vision_tokens: int = 0                  # > 0 expects vision_embeds

    @property
    def group_size(self) -> int:
        """Layers per stacked group (lcm of the layer-pattern periods)."""
        g = 1
        if self.num_experts and self.moe_layer_period > 1:
            g = _lcm(g, self.moe_layer_period)
        if self.global_attn_period:
            g = _lcm(g, self.global_attn_period)
        return g

    def layer_kind(self, idx: int) -> dict:
        """Static description of layer ``idx``'s flavour."""
        is_moe = bool(self.num_experts) and (
            (idx + 1) % max(self.moe_layer_period, 1) == 0)
        if self.global_attn_period:
            is_global = (idx + 1) % self.global_attn_period == 0
            window = None if is_global else self.sliding_window
        else:
            window = self.sliding_window
        return {"moe": is_moe, "window": window}

    def pdtype(self):
        return getattr(torch, self.param_dtype)

    def cdtype(self):
        return getattr(torch, self.compute_dtype)


def _lcm(a, b):
    return a * b // math.gcd(a, b)


def maybe_remat(fn, enabled):
    """``fn`` under ``torch.utils.checkpoint`` when ``enabled``: its
    activations are recomputed in the backward instead of stored (the JAX
    package's ``jax.checkpoint`` with nothing saveable)."""
    if not enabled:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def constrain_act(x, cfg, kind="residual"):
    """Activation sharding constraint: the identity on one device
    (``cfg.mesh_axes`` None). The sharded LM is a later slice."""
    del kind
    if getattr(cfg, "mesh_axes", None):
        raise NotImplementedError(
            "mesh_axes: the sharded LM belongs to a later slice of the port")
    return x


def constrain_dims(x, mesh_axes, roles):
    """Per-dim sharding constraint (``roles``: "dp" | "tp" | None per
    dim): the identity on one device (``mesh_axes`` None). The sharded LM
    is a later slice."""
    del roles
    if mesh_axes:
        raise NotImplementedError(
            "mesh_axes: the sharded LM belongs to a later slice of the port")
    return x


def count_params(params):
    """Number of scalars in a parameter tree."""
    return sum(int(x.numel()) for x in tree_leaves(params))
