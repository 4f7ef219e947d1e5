"""The plain reference of SFPL split-LM training on an afmoe model
(Trinity-Mini's architecture), in float32 and plain ``torch``: the
repository's reference for the port's ``trinity-mini`` and the
benchmark's for its ``split_lm`` cells, one file for both.

It imports no JAX, no ``repro`` and nothing of ``repro_torch``. Products
run in float32 with TF32 off. It takes the configuration under Hugging
Face's ``config.json`` names (``dims``) and covers:

* the model: the embedding scaled by sqrt(hidden) (muP); each layer
  ``x += post_attn_norm(attn(attn_norm(x)))``, ``x +=
  post_mlp_norm(ffn(pre_mlp_norm(x)))``; the attention with qk-norm,
  RoPE on the windowed layers only, a causal mask (and ``i - j <
  window`` on windowed layers), and the output gate ``o *
  sigmoid(h @ w_gate)`` before ``wo``; the first ``num_dense_layers``
  layers' SwiGLU, then the MoE: ``s = sigmoid(h @ w_router)`` over every
  expert, ``I = top_k(s + b)``, ``w = s_I / (sum s_I + 1e-20) *
  route_scale``, the held experts' ``w_j * SwiGLU_j(h)`` plus the shared
  expert; the final norm, the untied head over the vocabulary, the mean
  next-token cross-entropy;
* the SFPL cut after the dense layers: the client rows (whole sequences)
  and their labels permuted by the collector's permutation;
* the gradients (autograd over these plain ops), one AdamW step of every
  trainable leaf, and the expert bias's step ``b + rate * sign(mean(c) -
  c)`` from the forward's token-slots per expert.

Routing is by an explicit mask a held expert (the rows routed to it are
selected, computed and added back), with no sort and no capacity. The
attention runs in blocks of queries over the keys the mask lets through,
each block and each layer recomputed in the backward, so that the cell's
size fits on one card.

Departures from the published description (``config.json`` and Hugging
Face's ``AfmoeForCausalLM``):

* layer, expert and vocabulary counts are the configuration's cut: the
  experts ``[offset, offset + count)`` of ``experts_held`` are computed,
  as on one device of expert parallelism, and the others' part is left
  out, and so is the router's gradient, which would need it: where some
  experts are not held, the routing weights are taken as values (a
  gradient from the held experts alone drives the router away from
  them, and their load with it);
* the attention output gate, the qk-norm, the four norms a layer and
  RoPE on windowed layers only are not keys of ``config.json``: the
  configuration lists them under ``assumed``; the routing weight
  multiplies each expert's output (after the expert, not its input);
* AdamW's settings are the configuration's ``optimizer`` (not in
  ``config.json``), with the weight decay on every leaf;
* weights are drawn from a seed (``init_params``), and tokens are
  synthetic (``make_batch``).

Planted faults (``fault=``) for the benchmark's limits: ``all_full`` (no
window), ``rope_everywhere`` (RoPE on the full layers too),
``no_attn_gate``, ``no_route_norm`` (the top-k weights neither
normalised nor scaled), ``top1`` (one expert a token), ``half_batch``
(the loss over the first half of the clients' sequences only),
``half_rows`` (over the first half of the shuffled rows only);
``frozen=True`` returns the state it was given; ``precision="fp8"``
rounds every product's operands to float8 (e4m3 forward, e5m2 for the
gradient), the control.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FAULTS = ("all_full", "rope_everywhere", "no_attn_gate", "no_route_norm",
          "top1", "half_batch", "half_rows")
Q_BLOCK = 256


def dims(config):
    """The sizes the reference takes, from a configuration's Hugging Face
    keys (``bench/configs/*.json``): ``experts_held`` ``[offset, count]``
    and ``router_experts`` (the router's outputs) from its deployment."""
    dep = config["deployment"]
    return {
        "d": config["hidden_size"], "heads": config["num_attention_heads"],
        "kv": config["num_key_value_heads"], "hd": config["head_dim"],
        "layers": config["num_hidden_layers"],
        "dense": config["num_dense_layers"],
        "ff_dense": config["intermediate_size"],
        "ff": config["moe_intermediate_size"],
        "experts": dep["router_experts"],
        "held": tuple(dep["experts_held"]),
        "top_k": config["num_experts_per_tok"],
        "shared": config["num_shared_experts"],
        "route_norm": config["route_norm"],
        "route_scale": config["route_scale"],
        "window": config["sliding_window"],
        "period": config["global_attn_every_n_layers"],
        "theta": float(config["rope_theta"]),
        "eps": config["rms_norm_eps"], "vocab": config["vocab_size"],
        "bias_rate": config["load_balance_coeff"],
        "embed_scale": bool(config["mup_enabled"]),
    }


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# weights and data

def _normal(gen, shape, std):
    return torch.randn(shape, generator=gen, device=gen.device) * std


def _dense(gen, fan_in, fan_out):
    return {"w": _normal(gen, (fan_in, fan_out), 1 / math.sqrt(fan_in))}


def _swiglu(gen, d, f):
    return {"wi": _dense(gen, d, f), "wg": _dense(gen, d, f),
            "wo": _dense(gen, f, d)}


def _ones(n, gen):
    return {"scale": torch.ones(n, device=gen.device)}


def init_params(gen, m):
    """Float32 weights drawn from ``gen`` on its device, in the port's
    names: ``{"embed", "unembed", "final_norm", "layers": [...]}``."""
    d, H, K, D = m["d"], m["heads"], m["kv"], m["hd"]
    layers = []
    for i in range(m["layers"]):
        lp = {"attn_norm": _ones(d, gen), "post_attn_norm": _ones(d, gen),
              "mlp_norm": _ones(d, gen), "post_mlp_norm": _ones(d, gen),
              "attn": {"wq": _dense(gen, d, H * D),
                       "wk": _dense(gen, d, K * D),
                       "wv": _dense(gen, d, K * D),
                       "wo": _dense(gen, H * D, d),
                       "wgate": _dense(gen, d, H * D),
                       "q_norm": _ones(D, gen), "k_norm": _ones(D, gen)}}
        if i < m["dense"]:
            lp["mlp"] = _swiglu(gen, d, m["ff_dense"])
        else:
            n, f = m["held"][1], m["ff"]
            lp["moe"] = {
                "router": {"w": _normal(gen, (d, m["experts"]), 0.02)},
                "expert_bias": torch.zeros(m["experts"], device=gen.device),
                "wi": _normal(gen, (n, d, f), 1 / math.sqrt(d)),
                "wg": _normal(gen, (n, d, f), 1 / math.sqrt(d)),
                "wo": _normal(gen, (n, f, d), 1 / math.sqrt(f))}
            if m["shared"]:
                lp["moe"]["shared"] = _swiglu(gen, d, f)
        layers.append(lp)
    return {"embed": {"table": _normal(gen, (m["vocab"], d), 0.02)},
            "unembed": _dense(gen, d, m["vocab"]),
            "final_norm": _ones(d, gen), "layers": layers}


def make_batch(gen, clients, seq, vocab):
    """One step's data: client ``c`` holds one sequence of ``seq + 1`` ids
    drawn from its own band ``[c * vocab // clients, (c + 1) * vocab //
    clients)`` (its positive labels); ``(tokens, labels)`` (clients,
    seq), the labels the next ids."""
    band = vocab // clients
    lo = torch.arange(clients, device=gen.device)[:, None] * band
    ids = torch.randint(0, band, (clients, seq + 1), generator=gen,
                        device=gen.device) + lo
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()


def make_perm(gen, clients):
    """The collector's permutation of the client rows."""
    return torch.randperm(clients, generator=gen, device=gen.device)


def flat(params):
    """``{name: leaf}``: layer ``i``'s leaves under ``layers.<i>.``."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            out[".".join(path)] = t
    walk(params, ())
    return out


def is_buffer(name):
    return name.endswith("expert_bias")


# --------------------------------------------------------------------------
# the model

class _Fp8(torch.autograd.Function):
    """Round to float8 with a per-tensor scale: e4m3 forward, e5m2 for the
    gradient coming back."""

    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, 57344.0)


def _round_fp8(x, dtype, top):
    scale = top / x.detach().abs().amax().clamp_min(1e-12)
    return (x * scale).to(dtype).to(x.dtype) / scale


class Model:
    """The forward and loss at ``m``'s sizes, with a planted ``fault`` or
    the ``precision`` of the products."""

    def __init__(self, m, fault=None, precision="float32"):
        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}")
        self.m, self.fault = m, fault
        self.fp8 = precision == "fp8"
        self.routes = []        # each MoE layer's (experts (T, k), counts)

    def mm(self, a, b):
        if self.fp8:
            a, b = _Fp8.apply(a), _Fp8.apply(b)
        return a @ b

    def norm(self, p, x):
        ms = (x * x).mean(dim=-1, keepdim=True)
        return x / torch.sqrt(ms + self.m["eps"]) * p["scale"]

    def swiglu(self, p, x):
        h = F.silu(self.mm(x, p["wg"]["w"])) * self.mm(x, p["wi"]["w"])
        return self.mm(h, p["wo"]["w"])

    def rope(self, x):
        """x (B, S, heads, D) at positions 0..S-1: the halves of the last
        axis rotated, as the port's ``nn.rope.apply_rope``."""
        S, D = x.shape[1], x.shape[-1]
        inv = 1.0 / (self.m["theta"] ** (torch.arange(
            0, D, 2, dtype=torch.float32, device=x.device) / D))
        ang = torch.arange(S, dtype=torch.float32,
                           device=x.device)[:, None] * inv
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def window(self, i):
        """Layer ``i``'s window, ``None`` on a full layer."""
        full = (i + 1) % self.m["period"] == 0
        if full or self.fault == "all_full":
            return None
        return self.m["window"]

    def attention(self, p, h, i):
        m = self.m
        B, S, _ = h.shape
        H, K, D = m["heads"], m["kv"], m["hd"]
        q = self.mm(h, p["wq"]["w"]).reshape(B, S, H, D)
        k = self.mm(h, p["wk"]["w"]).reshape(B, S, K, D)
        v = self.mm(h, p["wv"]["w"]).reshape(B, S, K, D)
        q, k = self.norm(p["q_norm"], q), self.norm(p["k_norm"], k)
        win = self.window(i)
        if win is not None or self.fault == "rope_everywhere":
            q, k = self.rope(q), self.rope(k)
        # (B, heads, S, D), the kv heads repeated over their query heads
        q = q.transpose(1, 2)
        k = k.transpose(1, 2).repeat_interleave(H // K, dim=1)
        v = v.transpose(1, 2).repeat_interleave(H // K, dim=1)
        blocks = []
        for q0 in range(0, S, Q_BLOCK):
            q1 = min(q0 + Q_BLOCK, S)
            k0 = 0 if win is None else max(0, q0 - win + 1)
            blocks.append(checkpoint(self._block, q[:, :, q0:q1],
                                     k[:, :, k0:q1], v[:, :, k0:q1], q0, k0,
                                     win, use_reentrant=False))
        o = torch.cat(blocks, dim=2).transpose(1, 2).reshape(B, S, H * D)
        if self.fault != "no_attn_gate":
            o = o * torch.sigmoid(self.mm(h, p["wgate"]["w"]))
        return self.mm(o, p["wo"]["w"])

    def _block(self, q, k, v, q0, k0, win):
        s = self.mm(q, k.transpose(-1, -2)) / math.sqrt(self.m["hd"])
        qi = torch.arange(q0, q0 + q.shape[2], device=q.device)[:, None]
        kj = torch.arange(k0, k0 + k.shape[2], device=q.device)[None]
        keep = kj <= qi
        if win is not None:
            keep = keep & (qi - kj < win)
        s = s.masked_fill(~keep, float("-inf"))
        return self.mm(torch.softmax(s, dim=-1), v)

    def moe(self, p, h):
        m = self.m
        B, S, d = h.shape
        x = h.reshape(B * S, d)
        scores = torch.sigmoid(x @ p["router"]["w"])
        k = 1 if self.fault == "top1" else m["top_k"]
        idx = torch.topk(scores + p["expert_bias"], k, dim=-1).indices
        w = scores.gather(-1, idx)
        if m["route_norm"] and self.fault != "no_route_norm":
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20) * m["route_scale"]
        lo, n = m["held"]
        if n < m["experts"]:
            w = w.detach()      # the router's gradient needs every expert
        counts = torch.zeros(m["experts"], dtype=torch.int64,
                             device=x.device)
        counts.scatter_add_(0, idx.reshape(-1), torch.ones_like(
            idx.reshape(-1)))
        self.routes.append((idx.detach(), counts))
        y = torch.zeros_like(x)
        for e in range(n):
            hit = idx == lo + e                             # (T, k)
            rows = hit.any(dim=-1).nonzero().squeeze(1)
            if rows.numel() == 0:
                continue
            we = (w * hit).sum(dim=-1)[rows]
            xe = x[rows]
            he = F.silu(self.mm(xe, p["wg"][e])) * self.mm(xe, p["wi"][e])
            y = y.index_add(0, rows, we[:, None] * self.mm(he, p["wo"][e]))
        if "shared" in p:
            y = y + self.swiglu(p["shared"], x)
        return y.reshape(B, S, d)

    def layer(self, lp, x, i):
        x = x + self.norm(lp["post_attn_norm"], self.attention(
            lp["attn"], self.norm(lp["attn_norm"], x), i))
        h = self.norm(lp["mlp_norm"], x)
        y = self.swiglu(lp["mlp"], h) if "mlp" in lp else self.moe(lp["moe"],
                                                                   h)
        return x + self.norm(lp["post_mlp_norm"], y)

    def loss(self, params, tokens, labels, perm):
        """Mean next-token cross-entropy with the SFPL cut after the dense
        layers; each layer and each block of the head recomputed in the
        backward."""
        m = self.m
        x = params["embed"]["table"][tokens]
        if m["embed_scale"]:
            x = x * math.sqrt(m["d"])
        B = x.shape[0]
        keep = torch.ones(B, dtype=torch.bool, device=x.device)
        if self.fault == "half_batch":
            keep = perm < B // 2
        elif self.fault == "half_rows":
            keep = torch.arange(B, device=x.device) < B // 2
        for i, lp in enumerate(params["layers"]):
            if i == m["dense"]:
                x, labels = x[perm], labels[perm]
            x = checkpoint(self.layer, lp, x, i, use_reentrant=False)
        x = self.norm(params["final_norm"], x)[keep]
        B, S, d = x.shape
        x, labels = x.reshape(B * S, d), labels[keep].reshape(B * S)
        total = x.new_zeros(())
        rows = 8192
        for r0 in range(0, B * S, rows):
            total = total + checkpoint(self._xent, params["unembed"]["w"],
                                       x[r0:r0 + rows], labels[r0:r0 + rows],
                                       use_reentrant=False)
        return total / (B * S)

    def _xent(self, w, x, labels):
        return F.cross_entropy(self.mm(x, w), labels, reduction="sum")


# --------------------------------------------------------------------------
# training

def adamw_step(params, grads, state, step, opt):
    """One AdamW step of every trainable leaf (``flat`` names), as the
    port's ``optim.adamw``: bias correction at ``t = step + 1``, the
    decoupled weight decay added to the direction."""
    b1, b2, eps = opt["b1"], opt["b2"], opt["eps"]
    lr, wd = opt["lr"], opt["weight_decay"]
    t = float(step + 1)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    new = {}
    for k, p in params.items():
        g = grads[k]
        m = state["m"].get(k, torch.zeros_like(p)) * b1 + (1 - b1) * g
        v = state["v"].get(k, torch.zeros_like(p)) * b2 + (1 - b2) * g * g
        state["m"][k], state["v"][k] = m, v
        d = (m / c1) / (torch.sqrt(v / c2) + eps) + wd * p
        new[k] = p - lr * d
    return new


def train_steps(params, m, opt, batches, fault=None, precision="float32",
                frozen=False):
    """The checked steps from ``params`` (``init_params``'s tree) over
    ``batches`` (``(tokens, labels, perm)`` a step): ``{"losses",
    "first_grad", "params", "choices"}``, the first step's gradient and the
    final parameters by ``flat`` name, and the first MoE layer's experts
    a token at the first step, all on the host. ``frozen``: every step
    runs and the state stays as it was given (a zero gradient is what it
    took)."""
    no_tf32()
    leaves = flat(params)
    state = {"m": {}, "v": {}}
    losses, first_grad, choices = [], None, None
    for step, (tokens, labels, perm) in enumerate(batches):
        model = Model(m, fault, precision)
        train = {k: v.detach().requires_grad_() for k, v in leaves.items()
                 if not is_buffer(k)}
        tree = _unflat({**leaves, **train}, params)
        loss = model.loss(tree, tokens, labels, perm)
        routes = list(model.routes)     # the forward's, not the recompute's
        gs = torch.autograd.grad(loss, list(train.values()),
                                 allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(train.items(), gs)}
        losses.append(float(loss.detach()))
        if frozen:
            grads = {k: torch.zeros_like(g) for k, g in grads.items()}
        if first_grad is None:
            first_grad = {k: g.detach().cpu() for k, g in grads.items()}
            choices = routes[0][0].cpu()
        if frozen:
            continue
        new = adamw_step({k: v.detach() for k, v in train.items()}, grads,
                         state, step, opt)
        del grads, loss, train, tree
        moe = [k for k in leaves if is_buffer(k)]
        for k, (_, counts) in zip(moe, routes):
            c = counts.float()
            new[k] = leaves[k] + m["bias_rate"] * torch.sign(c.mean() - c)
        leaves = new
    return {"losses": losses, "first_grad": first_grad,
            "params": {k: v.cpu() for k, v in leaves.items()},
            "choices": choices}


def _unflat(leaves, like):
    def build(t, path):
        if isinstance(t, dict):
            return {k: build(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, list):
            return [build(v, path + (str(i),)) for i, v in enumerate(t)]
        return leaves[".".join(path)]
    return build(like, ())
