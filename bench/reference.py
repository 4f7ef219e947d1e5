"""Plain PyTorch reference of the SFPL training step on the split CIFAR
ResNet (He et al. 2016; the SFPL paper, arXiv:2307.13266, Algorithms 1-2).

Written from the papers, apart from the program: it imports nothing of
``repro_torch`` and takes nothing the program made. It runs in float32
with TF32 off (``torch.backends.cuda.matmul`` and ``torch.backends.cudnn``)
on NCHW tensors. One step, for ``clients`` clients of ``batch`` images
each:

* every client runs its own stem, a bias-free 3 x 3 conv, BatchNorm over
  its own batch (biased variance, eps 1e-5) and ReLU;
* the smashed data is pooled client-major (row ``k * batch + j`` is image
  ``j`` of client ``k``) and shuffled by a permutation drawn with
  ``torch.randperm(pool, generator=gen)`` from a CPU generator, one per
  step, labels alike;
* the server runs the residual stages (3 x 3 convs with XLA's "SAME"
  padding, so a stride-2 conv of an even input pads (0, 1); a 1 x 1
  stride-2 projection with BatchNorm where the shape changes), a global
  mean pool and the classifier, and takes the mean cross-entropy over the
  whole pool; BatchNorm in training uses the pool's batch statistics
  (each residual block is recomputed in the backward, which changes no
  number and keeps a pool of 12,800 rows within the card);
* one gradient of that loss reaches the server and, back through the
  shuffle, every client; each leaf takes SGD with momentum, the weight
  decay added to the gradient first (``mu = m * mu + g + wd * p``,
  ``p -= lr * mu``), on client and server alike;
* at the end of each epoch every client's non-BatchNorm parameters are
  replaced by their mean over the clients (FedAvg, BatchNorm excluded).

Running BatchNorm statistics are never read in training, so they are not
kept. Parameters are a flat dict of float32 leaves named as in
``param_shapes``: the clients' leaves carry a leading client axis.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

EPS = 1e-5
# running statistics: ``MOMENTUM * old + (1 - MOMENTUM) * batch``, the
# batch variance biased (the JAX package's convention)
MOMENTUM = 0.9


# --------------------------------------------------------------------------
# parameters

def blocks(cfg):
    """(name, cin, cout, stride) of every residual block in order."""
    w, n = cfg["width"], (cfg["depth"] - 2) // 6
    out, cin = [], w
    for stage, cout in enumerate((w, 2 * w, 4 * w)):
        for b in range(n):
            out.append((f"s{stage}b{b}", cin, cout,
                        2 if (stage > 0 and b == 0) else 1))
            cin = cout
    return out


def param_shapes(cfg):
    """Leaf name -> (shape, init) for one model; ``init`` is "he" (conv
    weights, std sqrt(2 / fan_in)), "lecun" (the classifier, std
    sqrt(1 / fan_in)), "one" or "zero". Conv weights are (out, in, k, k),
    the classifier (in, out)."""
    w, c = cfg["width"], cfg["num_classes"]
    out = {"client.conv1.w": ((w, cfg["in_channels"], 3, 3), "he"),
           "client.bn1.scale": ((w,), "one"),
           "client.bn1.bias": ((w,), "zero")}
    for name, cin, cout, stride in blocks(cfg):
        p = f"server.{name}."
        out[p + "conv1.w"] = ((cout, cin, 3, 3), "he")
        out[p + "bn1.scale"], out[p + "bn1.bias"] = ((cout,), "one"), \
            ((cout,), "zero")
        out[p + "conv2.w"] = ((cout, cout, 3, 3), "he")
        out[p + "bn2.scale"], out[p + "bn2.bias"] = ((cout,), "one"), \
            ((cout,), "zero")
        if stride != 1 or cin != cout:
            out[p + "proj.w"] = ((cout, cin, 1, 1), "he")
            out[p + "bn_proj.scale"] = ((cout,), "one")
            out[p + "bn_proj.bias"] = ((cout,), "zero")
    out["server.fc.w"] = ((4 * w, c), "lecun")
    out["server.fc.b"] = ((c,), "zero")
    return out


def init_params(gen, cfg):
    """One model's float32 leaves on ``gen``'s device, every random leaf
    cut from one normal draw and scaled by its fan-in."""
    shapes = param_shapes(cfg)
    rand = [(k, s) for k, (s, how) in shapes.items() if how in ("he",
                                                                "lecun")]
    flat = torch.randn(sum(math.prod(s) for _, s in rand), generator=gen,
                       device=gen.device)
    out, at = {}, 0
    for name, (shape, how) in shapes.items():
        if how == "one":
            out[name] = torch.ones(shape, device=gen.device)
        elif how == "zero":
            out[name] = torch.zeros(shape, device=gen.device)
        else:
            n = math.prod(shape)
            fan_in = shape[0] if how == "lecun" else math.prod(shape[1:])
            gain = 1.0 if how == "lecun" else 2.0
            out[name] = flat[at:at + n].view(shape) * math.sqrt(gain / fan_in)
            at += n
    return out


def stacked(params, clients):
    """The SFPL start: every client a copy of the one model's client
    leaves (a leading client axis), the server leaves as they are."""
    return {k: (v[None].repeat((clients,) + (1,) * v.dim())
                if k.startswith("client.") else v.clone())
            for k, v in params.items()}


def is_bn(name):
    return any(part.startswith("bn") for part in name.split("."))


# --------------------------------------------------------------------------
# precision of the products

class _Fp8(torch.autograd.Function):
    """Round to float8 with a per-tensor scale: e4m3 forward, e5m2 for the
    gradient coming back (the usual fp8 training recipe)."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


def _round_fp8(x, dtype, top):
    amax = x.detach().abs().amax().clamp_min(1e-12)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Bf16(torch.autograd.Function):
    """Round to bfloat16 both ways."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class Precision:
    """Where the reference rounds: ``"float32"`` nowhere; ``"fp8"`` the
    operands of every conv and of the classifier (the control: one step
    below the bfloat16 that the configurations compute in); ``"bfloat16"``
    those operands and every activation a bfloat16 program holds (conv,
    BatchNorm and block outputs, the smashed data, the logits), both ways
    (a witness of what bfloat16 alone does to the compared numbers)."""

    ROUND = {"float32": (None, None), "fp8": (_Fp8, None),
             "bfloat16": (_Bf16, _Bf16)}

    def __init__(self, mode="float32"):
        if mode not in self.ROUND:
            raise ValueError(f"unknown precision {mode!r}")
        self.operand, self.activation = self.ROUND[mode]

    def __call__(self, t):
        """An operand of a conv or of the classifier."""
        return t if self.operand is None else self.operand.apply(t)

    def act(self, t):
        """An activation."""
        return t if self.activation is None else self.activation.apply(t)


# --------------------------------------------------------------------------
# the step

def _same_pad(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, stride, q):
    k = w.shape[-1]
    lo, hi = _same_pad(x.shape[-1], k, stride)
    if lo != hi:
        x, lo = F.pad(x, (lo, hi, lo, hi)), 0
    return q.act(F.conv2d(q(x), q(w), stride=stride, padding=lo))


def batchnorm(x, scale, bias, record=None, name=None):
    """Training BatchNorm over (N, H, W) of an NCHW tensor; the batch
    variance goes to ``record[name]`` where given."""
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(0, 2, 3), keepdim=True)
    if record is not None:
        record[name] = var.detach().reshape(-1)
    return (x - mean) / torch.sqrt(var + EPS) * scale[:, None, None] \
        + bias[:, None, None]


def client_forward(p, x, q):
    """Every client's stem on its own batch: x (clients, batch, H, W, C)
    -> smashed data (clients, batch, width, H, W)."""
    outs = []
    for k in range(x.shape[0]):
        h = conv(x[k].permute(0, 3, 1, 2), p["client.conv1.w"][k], 1, q)
        h = batchnorm(h, p["client.bn1.scale"][k], p["client.bn1.bias"][k])
        outs.append(q.act(torch.relu(h)))
    return torch.stack(outs)


def server_loss(p, cfg, a, y, q, record=None):
    """The server's mean cross-entropy over the pool ``a`` (NCHW); each
    BatchNorm's batch variance goes to ``record`` under its leaf name."""
    def bn(x, key):
        return batchnorm(x, p[key + "scale"], p[key + "bias"], record,
                         key + "var")

    def block(h, pre, stride):
        t = conv(h, p[pre + "conv1.w"], stride, q)
        t = q.act(torch.relu(bn(t, pre + "bn1.")))
        t = conv(t, p[pre + "conv2.w"], 1, q)
        t = q.act(bn(t, pre + "bn2."))
        if pre + "proj.w" in p:
            h = conv(h, p[pre + "proj.w"], stride, q)
            h = q.act(bn(h, pre + "bn_proj."))
        return q.act(torch.relu(t + h))

    h = a
    for name, cin, cout, stride in blocks(cfg):
        # each block recomputed in the backward: the float32 graph of a
        # whole pool would not fit the card
        h = checkpoint(block, h, f"server.{name}.", stride,
                       use_reentrant=False)
    h = h.mean(dim=(2, 3))
    logits = q.act(q(h) @ q(p["server.fc.w"]) + p["server.fc.b"])
    return F.cross_entropy(logits, y)


def step_grads(p, cfg, x, y, perm, q, drop_half=None):
    """(loss, grads, the server BatchNorms' batch variances) of one SFPL
    step: client forward, pool, shuffle, server loss, one backward to
    every leaf. ``drop_half`` plants a fault: the server's step takes the
    mean over half of the pool, leaving out the rows of the second half of
    the clients (``"clients"``) or the second half of the shuffled rows
    (``"rows"``)."""
    var = {}
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    with torch.enable_grad():
        a = client_forward(leaves, x, q)
        pool = a.reshape((-1,) + tuple(a.shape[2:]))
        a_shuf, y_shuf = pool[perm], y.reshape(-1)[perm]
        half = pool.shape[0] // 2
        if drop_half == "clients":
            a_shuf, y_shuf = a_shuf[perm < half], y_shuf[perm < half]
        elif drop_half == "rows":
            a_shuf, y_shuf = a_shuf[:half], y_shuf[:half]
        loss = server_loss(leaves, cfg, a_shuf, y_shuf, q, var)
        names = list(leaves)
        gs = torch.autograd.grad(loss, [leaves[k] for k in names])
    return loss.detach(), dict(zip(names, gs)), var


def sgd(p, mu, g, opt):
    """SGD with momentum, weight decay added to the gradient first."""
    new_p, new_mu = {}, {}
    for k in p:
        m = opt["momentum"] * mu[k] + g[k] + opt["weight_decay"] * p[k]
        new_mu[k] = m
        new_p[k] = p[k] - opt["lr"] * m
    return new_p, new_mu


def fedavg(p):
    """Client non-BatchNorm leaves replaced by their mean over clients."""
    return {k: (v.mean(dim=0, keepdim=True).expand_as(v).clone()
                if k.startswith("client.") and not is_bn(k) else v)
            for k, v in p.items()}


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN convs while the reference runs."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def run_epochs(params, cfg, opt, data, batch, perm_gen, epoch_steps, *,
               precision="float32", drop_half=None, frozen=False):
    """Follow the program's checked steps: epochs of ``epoch_steps`` (a
    list, e.g. ``[1, 2]``) steps over consecutive batches of ``data``,
    FedAvg after each. Returns ``(losses, first_mu, first_var, params)``:
    each step's loss, the momentum after the first step (the first
    gradient as the optimizer takes it, weight decay included), the first
    step's batch variance at every server BatchNorm, and the parameters
    after the last epoch. ``frozen`` (a planted fault) leaves the state as it
    was at every step."""
    q = Precision(precision)
    p = stacked(params, data["x"].shape[0])
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    pool = data["x"].shape[0] * batch
    losses, first_mu, first_var, idx = [], None, None, 0
    with float32_exact():
        for steps in epoch_steps:
            for _ in range(steps):
                sl = slice(idx * batch, (idx + 1) * batch)
                perm = torch.randperm(pool, generator=perm_gen).to(
                    data["x"].device)
                loss, g, var = step_grads(p, cfg, data["x"][:, sl],
                                          data["y"][:, sl], perm, q,
                                          drop_half)
                if not frozen:
                    p, mu = sgd(p, mu, g, opt)
                losses.append(float(loss))
                if first_mu is None:
                    first_mu = {k: v.clone() for k, v in mu.items()}
                    first_var = var
                idx += 1
            p = fedavg(p)
    return losses, first_mu, first_var, p
