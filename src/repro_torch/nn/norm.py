"""BatchNorm with explicit running statistics (RMSD / CMSD at inference),
LayerNorm and RMSNorm.

Running statistics live in a separate ``state`` dict, as in the JAX
package, so the aggregation policies can treat them apart from the
parameters. The running update is ``0.9 * old + 0.1 * batch`` with the
*biased* batch variance plus a ``count`` leaf, computed by hand:
``F.batch_norm``'s update uses the unbiased variance and the other
momentum convention.

Parameters may carry a leading client axis (``scale`` of shape (N, C)):
the input is then client-stacked (N, B, ..., C) and every client is
normalized with its own moments, the JAX package's ``vmap`` written out.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.rmsnorm import ops as rms_ops, ref as rms_ref
from repro_torch.nn.init import ones, zeros
from repro_torch.trace import span


def _batch_moments(x, axes, valid, reduce=None):
    """f32 (mean, var) over ``axes``; rows with ``valid == False`` carry no
    weight (``valid`` is a ``(batch,)`` bool mask over axis 0). ``reduce``
    (a differentiable sum over ranks) makes them the moments of the batch
    of every rank, each holding a slab of it."""
    x32 = x.float()
    if reduce is not None:
        return _global_moments(x32, axes, valid, reduce)
    if valid is None:
        var, mean = torch.var_mean(x32, dim=axes, correction=0)
        return mean, var
    w = valid.float().reshape((-1,) + (1,) * (x32.dim() - 1))
    spatial = math.prod(x32.shape[i] for i in axes if i != 0)
    cnt = torch.clamp_min(w.sum(), 1.0) * float(spatial)
    mean = (x32 * w).sum(dim=axes) / cnt
    var = (w * (x32 - mean).square()).sum(dim=axes) / cnt
    return mean, var


def _global_moments(x32, axes, valid, reduce):
    """Two-pass moments of a batch split over ranks: the sums and the
    counts are all-reduced, then the squared deviations from the global
    mean."""
    spatial = math.prod(x32.shape[i] for i in axes if i != 0)
    if valid is None:
        cnt = reduce(x32.new_full((), float(x32.shape[0] * spatial)))
        mean = reduce(x32.sum(dim=axes)) / cnt
        var = reduce((x32 - mean).square().sum(dim=axes)) / cnt
        return mean, var
    w = valid.float().reshape((-1,) + (1,) * (x32.dim() - 1))
    cnt = torch.clamp_min(reduce(w.sum()), 1.0) * float(spatial)
    mean = reduce((x32 * w).sum(dim=axes)) / cnt
    var = reduce((w * (x32 - mean).square()).sum(dim=axes)) / cnt
    return mean, var


def batchnorm_init(gen, dim, *, dtype=torch.float32):
    params = {"scale": ones(gen, (dim,), dtype),
              "bias": zeros(gen, (dim,), dtype)}
    state = {"mean": torch.zeros(dim), "var": torch.ones(dim),
             "count": torch.zeros(())}
    return params, state


def _stats(state, x, *, training, momentum, use_running_stats, valid,
           reduce=None):
    """(mean, var, new_state) for one BN call; the statistics stay in the
    autograd graph, the new running state does not."""
    stacked = state["mean"].dim() == 2
    axes = tuple(range(1 if stacked else 0, x.dim() - 1))
    rmsd = True if use_running_stats is None else use_running_stats
    if not training and rmsd:
        return state["mean"], state["var"], state
    with span("bn.stats"):
        mean, var = _batch_moments(x, axes, valid, reduce)
        if not training:                # CMSD: the batch's own moments
            return mean, var, state
        new_state = {
            "mean": momentum * state["mean"] + (1 - momentum) * mean.detach(),
            "var": momentum * state["var"] + (1 - momentum) * var.detach(),
            "count": state["count"] + 1.0,
        }
    return mean, var, new_state


def _takes_train_op(x, *, training, use_kernel, use_running_stats, valid,
                    reduce):
    """Whether a ``batchnorm_act_apply`` call runs the BatchNorm training
    op: a CUDA input with ``use_kernel``, the batch's own moments
    (training, or CMSD inference), and no ``valid`` row mask or ``reduce``
    over ranks, which keep the plain code."""
    rmsd = True if use_running_stats is None else use_running_stats
    return bool(use_kernel and x.is_cuda and (training or not rmsd)
                and valid is None and reduce is None)


def _per_channel(t, x):
    """Broadcast a (C,) or client-stacked (N, C) vector against x."""
    if t.dim() == 1:
        return t
    return t.reshape((t.shape[0],) + (1,) * (x.dim() - 2) + (t.shape[1],))


def batchnorm_apply(params, state, x, *, training, momentum=0.9, eps=1e-5,
                    use_running_stats=None, valid=None, reduce=None):
    """Returns (y, new_state). Training normalizes with the batch
    statistics and updates the running ones; inference uses the running
    statistics (RMSD, the default) or the test batch's own (CMSD,
    ``use_running_stats=False``). ``valid`` drops rows from the batch
    statistics; ``reduce`` (a differentiable sum over ranks) takes them
    over a batch split across ranks."""
    mean, var, new_state = _stats(state, x, training=training,
                                  momentum=momentum,
                                  use_running_stats=use_running_stats,
                                  valid=valid, reduce=reduce)
    with span("bn.act"):
        x32 = x.float()
        y = (x32 - _per_channel(mean, x)) * _per_channel(
            1.0 / torch.sqrt(var + eps), x)
        y = y * _per_channel(params["scale"].float(), x) \
            + _per_channel(params["bias"].float(), x)
        return y.to(x.dtype), new_state


def batchnorm_act_apply(params, state, x, *, training, relu=True,
                        momentum=0.9, eps=1e-5, use_running_stats=None,
                        use_kernel=False, valid=None, reduce=None):
    """BatchNorm + optional ReLU with the elementwise tail fused.

    Same statistics as :func:`batchnorm_apply`, but the per-channel
    normalize/scale/shift is folded into one f32 affine
    ``a = scale / sqrt(var + eps)``, ``b = bias - mean * a``, applied with
    the ReLU in one sweep over ``x``: the ``bn_act`` kernel when
    ``use_kernel`` (its wrapper runs the plain version for a CPU tensor),
    else plain PyTorch. The fold rounds differently from the unfused form,
    so the f32 parity path (``policy=None``) keeps :func:`batchnorm_apply`.

    A CUDA call with ``use_kernel`` that normalises by the batch's own
    moments (training, or CMSD) over the whole local batch (no ``valid``,
    no ``reduce``) is the hand-written training op
    (``kernels.bn_act.ops.bn_train``): f32 moments read from ``x`` itself,
    the fold and running update in the same launch, K2, and a two-kernel
    backward through all of them, with nothing f32 of x's size kept.
    """
    if _takes_train_op(x, training=training, use_kernel=use_kernel,
                       use_running_stats=use_running_stats, valid=valid,
                       reduce=reduce):
        from repro_torch.kernels.bn_act import ops
        with span("bn.act"):
            y, new = ops.bn_train(
                x, params["scale"].float(), params["bias"].float(),
                state["mean"], state["var"], state["count"],
                training=training, relu=relu, momentum=momentum, eps=eps)
        if new is None:
            return y, state
        return y, dict(zip(("mean", "var", "count"), new))
    mean, var, new_state = _stats(state, x, training=training,
                                  momentum=momentum,
                                  use_running_stats=use_running_stats,
                                  valid=valid, reduce=reduce)
    with span("bn.act"):
        a = params["scale"].float() / torch.sqrt(var + eps)
        b = params["bias"].float() - mean * a
        if use_kernel:
            from repro_torch.kernels.bn_act import ops
            return ops.bn_act(x, a, b, relu=relu), new_state
        y32 = x.float() * _per_channel(a, x) + _per_channel(b, x)
        if relu:
            y32 = torch.clamp_min(y32, 0.0)
        return y32.to(x.dtype), new_state


# --------------------------------------------------------------------------
# LayerNorm / RMSNorm


def layernorm_init(gen, dim, *, dtype=torch.float32):
    return {"scale": ones(gen, (dim,), dtype),
            "bias": zeros(gen, (dim,), dtype)}


def layernorm_apply(params, x, *, eps=1e-5):
    """LayerNorm over the last axis: mean and biased variance in f32, the
    result in ``x.dtype``."""
    x32 = x.float()
    var, mu = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) / torch.sqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rmsnorm_init(gen, dim, *, dtype=torch.float32):
    return {"scale": ones(gen, (dim,), dtype)}


def rmsnorm_apply(params, x, *, eps=1e-6, use_kernel=False,
                  scale_offset=0.0):
    """RMSNorm over the last axis in f32, returned in ``x.dtype``;
    ``scale_offset=1.0`` gives Gemma's ``(1 + scale)`` convention.

    The plain path is the K6 kernel's plain version; ``use_kernel`` routes
    through the kernel's wrapper (K6, forward only; it runs the plain
    version for a CPU tensor). As in the JAX package, no model sets it."""
    rms = rms_ops.rmsnorm if use_kernel else rms_ref.rmsnorm_ref
    return rms(x, params["scale"], eps=eps, scale_offset=scale_offset)
