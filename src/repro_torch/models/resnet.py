"""CIFAR ResNet-8/32/56 (He et al. 2016), split for splitfed learning.

Params and state split into ``client`` and ``server`` subtrees at the
paper's cut: the client holds the first 3x3 conv + BN + ReLU, the server
the three residual stages, the pooled head and the classifier. The tree
keys are the JAX package's (``conv1``, ``bn1``, ``s{stage}b{b}``,
``proj``, ``bn_proj``, ``fc``), so FedAvg's "key starts with bn" rule
carries over. Activations are NHWC.

``client_apply`` also takes client-stacked params (leading client axis)
with client-stacked input (N, B, H, W, 3): all clients run at once.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.nn.conv import conv2d_init, conv2d_apply
from repro_torch.nn.linear import dense_init, dense_apply
from repro_torch.nn.norm import (batchnorm_init, batchnorm_apply,
                                 batchnorm_act_apply)


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 8                  # 8 / 32 / 56  (= 6n+2)
    num_classes: int = 10
    width: int = 16

    @property
    def blocks_per_stage(self) -> int:
        if (self.depth - 2) % 6:
            raise ValueError(f"ResNet depth must be 6n+2, got {self.depth}")
        return (self.depth - 2) // 6


# --------------------------------------------------------------------------
# init

def _block_init(gen, cin, cout, stride):
    p, s = {}, {}
    p["conv1"] = conv2d_init(gen, cin, cout, 3)
    p["bn1"], s["bn1"] = batchnorm_init(gen, cout)
    p["conv2"] = conv2d_init(gen, cout, cout, 3)
    p["bn2"], s["bn2"] = batchnorm_init(gen, cout)
    if stride != 1 or cin != cout:
        p["proj"] = conv2d_init(gen, cin, cout, 1)
        p["bn_proj"], s["bn_proj"] = batchnorm_init(gen, cout)
    return p, s


def init(gen, cfg: ResNetConfig):
    """Random params and BN state on the CPU, drawn from ``gen``."""
    w = cfg.width
    client_p = {"conv1": conv2d_init(gen, 3, w, 3)}
    client_p["bn1"], bn_s = batchnorm_init(gen, w)
    client_s = {"bn1": bn_s}
    server_p, server_s = {}, {}
    cin = w
    for stage, cout in enumerate([w, 2 * w, 4 * w]):
        for b in range(cfg.blocks_per_stage):
            stride = 2 if (stage > 0 and b == 0) else 1
            name = f"s{stage}b{b}"
            server_p[name], server_s[name] = _block_init(gen, cin, cout,
                                                         stride)
            cin = cout
    server_p["fc"] = dense_init(gen, 4 * w, cfg.num_classes)
    return ({"client": client_p, "server": server_p},
            {"client": client_s, "server": server_s})


# --------------------------------------------------------------------------
# apply
#
# ``policy`` (a models.common.ComputePolicy or None) selects the compute
# path. None keeps the unfused f32 graph (the folded BN affine rounds
# differently). With a policy, convs and the dense layer run in
# ``policy.compute_dtype`` and every BN (with the ReLU after it, where
# there is one) is the folded ``batchnorm_act_apply`` epilogue: the
# ``bn_act`` kernel when ``policy.fused()``. BN statistics stay f32.


def _cd(policy):
    return policy.cdtype() if policy is not None and policy.mixed else None


def _bn(p, s, x, *, training, rmsd, policy=None, relu=False, valid=None,
        reduce=None):
    if policy is None:
        y, ns = batchnorm_apply(p, s, x, training=training,
                                use_running_stats=rmsd, valid=valid,
                                reduce=reduce)
        return (torch.relu(y) if relu else y), ns
    return batchnorm_act_apply(p, s, x, training=training, relu=relu,
                               use_running_stats=rmsd,
                               use_kernel=policy.fused(), valid=valid,
                               reduce=reduce)


def client_apply(params, state, x, *, training=True, rmsd=None, policy=None,
                 reduce=None):
    """x (B, H, W, 3) -> smashed data (B, H, W, width), or client-stacked
    (N, B, H, W, 3) -> (N, B, H, W, width) with client-stacked params.
    Returns (a, new_state); ``a`` is in the compute dtype. ``reduce`` (a
    differentiable sum over ranks, one client's batch split over them)
    takes the BN statistics over the whole batch."""
    if policy is not None:
        x = policy.cast(x)
    h = conv2d_apply(params["conv1"], x, compute_dtype=_cd(policy))
    h, bn1 = _bn(params["bn1"], state["bn1"], h, training=training,
                 rmsd=rmsd, policy=policy, relu=True, reduce=reduce)
    return h, {"bn1": bn1}


def _block_apply(p, s, x, stride, *, training, rmsd, policy=None,
                 valid=None, reduce=None):
    ns = {}
    cd = _cd(policy)
    bn = dict(training=training, rmsd=rmsd, policy=policy, valid=valid,
              reduce=reduce)
    h = conv2d_apply(p["conv1"], x, stride=stride, compute_dtype=cd)
    h, ns["bn1"] = _bn(p["bn1"], s["bn1"], h, relu=True, **bn)
    h = conv2d_apply(p["conv2"], h, compute_dtype=cd)
    h, ns["bn2"] = _bn(p["bn2"], s["bn2"], h, **bn)
    if "proj" in p:
        x = conv2d_apply(p["proj"], x, stride=stride, compute_dtype=cd)
        x, ns["bn_proj"] = _bn(p["bn_proj"], s["bn_proj"], x, **bn)
    return torch.relu(h + x), ns


def server_apply(params, state, a, cfg: ResNetConfig, *, training=True,
                 rmsd=None, policy=None, valid=None, reduce=None):
    """a: smashed data (B, H, W, width) -> logits. Returns (logits, state).
    ``valid`` (optional (B,) bool) drops rows from every BN statistic;
    ``reduce`` (a differentiable sum over ranks) takes every BN statistic
    over the batch of all ranks, ``a`` being this rank's slab of it."""
    ns = {}
    h = a if policy is None else policy.cast(a)
    for stage in range(3):
        for b in range(cfg.blocks_per_stage):
            stride = 2 if (stage > 0 and b == 0) else 1
            name = f"s{stage}b{b}"
            h, ns[name] = _block_apply(params[name], state[name], h, stride,
                                       training=training, rmsd=rmsd,
                                       policy=policy, valid=valid,
                                       reduce=reduce)
    h = h.mean(dim=(1, 2))
    return dense_apply(params["fc"], h, compute_dtype=_cd(policy)), ns


def apply(params, state, x, cfg: ResNetConfig, *, training=True, rmsd=None,
          policy=None):
    a, cs = client_apply(params["client"], state["client"], x,
                         training=training, rmsd=rmsd, policy=policy)
    logits, ss = server_apply(params["server"], state["server"], a, cfg,
                              training=training, rmsd=rmsd, policy=policy)
    return logits, {"client": cs, "server": ss}


def client_flops_per_datapoint(cfg: ResNetConfig, hw=32):
    """MAC count of the client portion (the paper's Table IV)."""
    conv = 3 * 3 * 3 * cfg.width * hw * hw   # 3x3 conv, stride 1, SAME
    bn = 2 * cfg.width * hw * hw             # scale + shift
    return conv + bn
