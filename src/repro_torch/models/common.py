"""Shared model pieces: the compute policy, the losses and accuracy, the
transformer config, rematerialisation, and the models' sharding
constraints (DTensor redistributions under ``mesh_axes`` through
``repro_torch.sharding.dtensor``, identities on plain tensors)."""
from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.sharding.dtensor import (apply_spec, dims_spec, dp_tp,
                                          is_dtensor, local_region,
                                          shard_start)
from repro_torch.sharding.rules import mesh_axes_of
from repro_torch.tree import tree_leaves, tree_map

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


def _logsumexp(logits):
    """``logsumexp`` over the last dim. On a DTensor (the vocab may be
    sharded) from a max and a sum, which shard along the vocab, where
    DTensor's ``logsumexp`` gathers it whole."""
    if not is_dtensor(logits):
        return torch.logsumexp(logits, dim=-1)
    m = logits.detach().amax(dim=-1, keepdim=True)
    return (m + torch.log(torch.exp(logits - m).sum(dim=-1,
                                                   keepdim=True)))[..., 0]


def _pick(logits, labels):
    """``logits[..., labels]``. On a DTensor whose vocab is sharded each
    device picks from its own columns (zero where the label is another
    device's) and the picks are summed over the vocab's shards, which
    adds exact zeros to the one picked value."""
    if not is_dtensor(logits):
        return logits.gather(-1, labels[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh, last = logits.device_mesh, logits.dim() - 1
    pl = [Replicate() if p.is_partial() else p for p in logits.placements]
    logits = logits.redistribute(mesh, pl)
    vocab = [m for m, p in enumerate(pl) if p.is_shard(last)]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    labels = labels.redistribute(mesh, [
        Replicate() if m in vocab else p
        for m, p in enumerate(labels.placements)])
    lo, cols = shard_start(mesh, vocab, logits.shape[-1])

    def pick(x, i):
        j = i - lo
        hit = (j >= 0) & (j < cols)
        got = x.gather(-1, j.clamp(0, cols - 1)[..., None])[..., 0]
        return got * hit.to(got.dtype)

    out_pl = [Partial() if m in vocab else p for m, p in enumerate(pl)]
    return local_map(pick, out_pl, in_placements=(tuple(pl),
                                                  tuple(labels.placements)),
                     in_grad_placements=(tuple(pl),
                                         tuple(labels.placements)))(
        logits, labels)


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
    lse = _logsumexp(logits)
    ll = _pick(logits, safe)
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
        lse = _logsumexp(logits)
        ll = _pick(logits, safe)
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
    """One config covers dense / GQA / MoE / VLM decoder variants."""
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
    num_experts: int = 0                    # the router's outputs
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
    attention_impl: str = "xla"             # "xla" | "kernel" (K7) | "flex"
    remat: bool = True
    scan_layers: bool = True
    mesh_axes: Optional[Tuple[Tuple[str, int], ...]] = None
    vision_tokens: int = 0                  # > 0 expects vision_embeds

    # afmoe's parts, absent here: class attributes, so that this class's
    # fields stay the JAX package's (``AfmoeConfig`` sets them)
    moe_routing = "top1"        # llama4's capacity-dropping top-1
    global_rope = True          # RoPE on the full layers too
    attn_out_gate = False
    sandwich_norm = False       # RMSNorm after the attention and FFN too
    num_dense_layers = 0

    @property
    def group_size(self) -> int:
        """Layers per stacked group (lcm of the layer-pattern periods; 1
        with leading dense layers, whose kinds follow the absolute
        index)."""
        if self.num_dense_layers:
            return 1
        g = 1
        if self.num_experts and self.moe_layer_period > 1:
            g = _lcm(g, self.moe_layer_period)
        if self.global_attn_period:
            g = _lcm(g, self.global_attn_period)
        return g

    def layer_kind(self, idx: int) -> dict:
        """Static description of layer ``idx``'s flavour (``idx`` is the
        absolute index; the periods divide the group size, so a layer's
        place in its group gives the same)."""
        is_moe = bool(self.num_experts) and idx >= self.num_dense_layers \
            and (idx + 1) % max(self.moe_layer_period, 1) == 0
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


@dataclasses.dataclass(frozen=True)
class AfmoeConfig(TransformerConfig):
    """A transformer with afmoe's parts (trinity-mini), which the JAX
    package does not have: the MoE is sigmoid top-k over every expert,
    its weights normalised and scaled, dropless, computing the held
    experts' rows (``nn.moe.moe_dropless_apply``, TorchTitan's token
    choice); the full layers have no RoPE; the attention's output is
    gated by ``sigmoid(h @ w_gate)``; an RMSNorm follows the attention
    and the FFN as well as preceding them."""
    moe_routing = "dropless"
    global_rope = False
    attn_out_gate = True
    sandwich_norm = True
    moe_top_k: int = 8
    route_scale: float = 1.0
    experts_held: Optional[Tuple[int, int]] = None  # (offset, count); None=all
    expert_bias_rate: float = 0.0           # aux-loss-free bias step
    # leading dense layers, stacked apart; with any, layer kinds follow the
    # absolute index and the other layers are stacked one a group
    num_dense_layers: int = 0


def _lcm(a, b):
    return a * b // math.gcd(a, b)


def stacked_init(draw, n):
    """``n`` draws of ``draw()`` stacked on a leading axis, as the JAX
    package stacks its layer groups. Each draw is written into the
    preallocated leaves before the next is made, so the peak is the stack
    plus one draw; with ``n == 1`` the stacked leaves are views of the one
    draw, with no copy."""
    one = draw()
    if n == 1:
        return tree_map(lambda a: a.unsqueeze(0), one)
    out = tree_map(lambda a: a.new_empty((n,) + a.shape), one)
    for i in range(n):
        if i:
            one = draw()
        tree_map(lambda dst, src: dst[i].copy_(src), out, one)
        del one
    return out


def maybe_remat(fn, enabled):
    """``fn`` under ``torch.utils.checkpoint`` when ``enabled``: its
    activations are recomputed in the backward instead of stored (the JAX
    package's ``jax.checkpoint`` with nothing saveable)."""
    if not enabled:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def take_rows(x, perm):
    """``x[perm]`` along the batch dim: SFPL's collector shuffle of the
    smashed data (and their labels). A plain float CUDA tensor goes
    through the collector's K1 (``collector_permute``) over its rows of
    the last dim, the batch permutation expanded to them, under the
    ``collector.permute`` span and counted in
    ``COUNTERS["sfpl"]["permuted_bytes"]``. On a DTensor the batch is
    gathered whole (the collector's exchange), each device permutes it,
    and the result is laid out as ``x`` was; its backward is the
    de-shuffle."""
    if not is_dtensor(x):
        if x.is_cuda and x.is_floating_point() and x.dim() >= 2:
            return _k1_take_rows(x, perm.to(x.device))
        return x.index_select(0, perm.to(x.device))
    mesh_axes = mesh_axes_of(x.device_mesh)
    whole = (None,) * x.dim()
    out = local_region(lambda x_, p_: x_.index_select(0, p_), mesh_axes,
                       [whole, (None,)], whole)(x, perm)
    return out.redistribute(x.device_mesh, x.placements)


def expand_perm(perm, inner):
    """A permutation of ``len(perm)`` blocks of ``inner`` rows each, as a
    permutation of the rows: row ``i * inner + j`` of the result is row
    ``perm[i] * inner + j`` of the input."""
    j = torch.arange(inner, device=perm.device, dtype=torch.int64)
    return (perm.long()[:, None] * inner + j).reshape(-1)


def _k1_take_rows(x, perm):
    from repro_torch.kernels.collector_permute.ops import collector_permute
    from repro_torch.trace import COUNTERS, span
    with span("collector.permute"):
        COUNTERS["sfpl"]["permuted_bytes"] += x.numel() * x.element_size()
        d = x.shape[-1]
        rows = x.reshape(-1, d)
        out = collector_permute(rows, expand_perm(perm,
                                                  rows.shape[0] // len(perm)))
        return out.reshape(x.shape)


def constrain_dims(x, mesh_axes, roles):
    """Per-dim sharding constraint. ``roles``: "dp" | "tp" | None per dim,
    each guarded by divisibility. The identity without ``mesh_axes`` or
    on a plain tensor; a DTensor is redistributed (:func:`apply_spec`)."""
    if not mesh_axes:
        return x
    return apply_spec(x, mesh_axes, dims_spec(x.shape, mesh_axes, roles))


def constrain_act(x, cfg, kind="residual"):
    """Sharding constraints on activations (the identity when
    ``cfg.mesh_axes`` is unset or ``x`` is a plain tensor; a dim the axis
    does not divide stays replicated).

    kinds: "residual" (B, S, d) -> (dp, "model", None)  [sequence parallel]
           "logits"   (B, S, V) -> (dp, None, "model")  [vocab sharded]
    """
    axes = getattr(cfg, "mesh_axes", None)
    if not axes:
        return x
    dp, dp_size, tp = dp_tp(axes)
    b_ok = x.shape[0] % dp_size == 0 and x.shape[0] >= dp_size
    spec = [dp if b_ok else None, None, None]
    if kind == "residual":
        if x.shape[1] % tp == 0 and x.shape[1] >= tp:
            spec[1] = "model"
        elif not b_ok and x.shape[1] % (dp_size * tp) == 0:
            # batch 1, long context: the sequence over everything
            spec[1] = dp + ("model",)
    elif kind == "logits":
        if x.shape[-1] % tp == 0:
            spec[-1] = "model"
        if not b_ok and x.shape[1] % dp_size == 0 and x.shape[1] >= dp_size:
            spec[1] = dp
    return apply_spec(x, axes, spec)


def count_params(params):
    """Number of scalars in a parameter tree."""
    return sum(int(x.numel()) for x in tree_leaves(params))
