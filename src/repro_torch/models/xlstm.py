"""xLSTM (arXiv:2405.04517): mLSTM + sLSTM residual blocks, 7:1 ratio, for
training (``loss_fn``), prefill and cached decode.

* mLSTM: the chunkwise-parallel form. Within a chunk of ``chunk_len`` the
  stabilized quadratic form runs as f32 matmuls; across chunks a (C, n, m)
  matrix-memory state is carried. Decode runs the recurrent step.
* sLSTM: sequential over time, with per-head block-diagonal recurrent
  matrices. ``slstm_impl="kernel"`` runs the time loop in the K8 kernel
  (``kernels/slstm_scan``; its plain version for CPU tensors), ``"xla"`` a
  Python loop of the cell step. Decode runs the plain cell step, as the
  JAX package does.

Blocks come in groups of ``slstm_every`` (mLSTM blocks, then one sLSTM).
Per-group parameters are stacked on a leading ``num_groups`` axis as the
JAX package stacks them, so parameter trees carry across
(``repro_torch.convert``); its ``lax.scan`` over the groups is a Python
loop here, and its per-block rematerialisation in training (``remat``, a
memory policy that changes no value) is not ported. As in the JAX
package, the xLSTM takes no ``collector_perm``: SFPL LM training runs its
plain loss (``launch/steps.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.models.common import (chunked_lm_loss, constrain_act,
                                       constrain_dims)
from repro_torch.nn.init import normal_init, zeros
from repro_torch.nn.linear import (
    dense_init, dense_apply, embedding_init, embedding_apply,
    embedding_attend)
from repro_torch.nn.norm import rmsnorm_init, rmsnorm_apply
from repro_torch.tree import tree_map

GATES = ("i", "f", "z", "o")
SLSTM_IMPLS = ("xla", "kernel")
# the JAX package's names for its kernel path
_KERNEL_ALIASES = ("pallas", "pallas_interpret")


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    name: str = "xlstm"
    num_layers: int = 48
    d_model: int = 2048
    num_heads: int = 4
    vocab_size: int = 50304
    proj_factor: float = 2.0        # mLSTM up-projection
    slstm_ff_factor: float = 4.0 / 3.0
    conv_kernel: int = 4
    qkv_blocksize: int = 4          # block-diagonal qkv (official xlstm)
    slstm_every: int = 8            # one sLSTM per 8 blocks (7:1)
    chunk_len: int = 256
    slstm_impl: str = "xla"         # "xla" | "kernel" (K8)
    norm_eps: float = 1e-6
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    mesh_axes: Optional[tuple] = None

    def __post_init__(self):
        impl = ("kernel" if self.slstm_impl in _KERNEL_ALIASES
                else self.slstm_impl)
        if impl not in SLSTM_IMPLS:
            raise ValueError(f"slstm_impl in {SLSTM_IMPLS} (or the JAX "
                             f"package's {_KERNEL_ALIASES}); got "
                             f"{self.slstm_impl!r}")
        object.__setattr__(self, "slstm_impl", impl)

    @property
    def d_inner(self):
        return int(self.d_model * self.proj_factor)

    @property
    def head_dim(self):
        return self.d_inner // self.num_heads

    def pdtype(self):
        return getattr(torch, self.param_dtype)

    def cdtype(self):
        return getattr(torch, self.compute_dtype)


# --------------------------------------------------------------------------
# causal depthwise conv (kernel 4) with a decode ring buffer

def causal_conv_init(gen, dim, kernel, dtype):
    return {"w": normal_init(gen, (kernel, dim), stddev=0.1, dtype=dtype),
            "b": zeros(gen, (dim,), dtype=dtype)}


def causal_conv_apply(p, x):
    """x: (B, S, D) depthwise causal conv."""
    k = p["w"].shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]] * p["w"][i].to(x.dtype)
    return out + p["b"].to(x.dtype)


def causal_conv_step(p, x_t, buf):
    """x_t: (B, D); buf: (B, k-1, D) previous inputs. Returns (y, new_buf)."""
    k = p["w"].shape[0]
    window = torch.cat([buf, x_t[:, None]], dim=1)             # (B, k, D)
    y = torch.einsum("bkd,kd->bd", window, p["w"].to(x_t.dtype))
    y = y + p["b"].to(x_t.dtype)
    return y, window[:, -(k - 1):]


# --------------------------------------------------------------------------
# mLSTM cell: chunkwise parallel + recurrent step, in f32

def _mlstm_chunk_scan(q, k, v, i_pre, logf, *, chunk, mesh_axes=None):
    """q, k, v: (B, H, S, D) (q pre-scaled); i_pre / logf: (B, H, S) f32.

    Returns h: (B, H, S, D) f32. Chunkwise stabilized linear-attention form.
    """
    B, H, S, D = q.shape
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk "
                         f"{chunk}")
    dev = q.device
    f32 = torch.float32
    C = torch.zeros((B, H, D, D), dtype=f32, device=dev)
    n = torch.zeros((B, H, D), dtype=f32, device=dev)
    m = torch.full((B, H), -1e30, dtype=f32, device=dev)
    above = torch.ones((chunk, chunk), dtype=torch.bool,
                       device=dev).triu(1)
    hs = []
    for j in range(S // chunk):
        sl = slice(j * chunk, (j + 1) * chunk)
        qj, kj, vj = (a[:, :, sl].float() for a in (q, k, v))
        ij, fj = i_pre[:, :, sl], logf[:, :, sl]
        Bcum = torch.cumsum(fj, dim=-1)                       # (B, H, L)
        # intra-chunk exponents  D_ts = Bcum_t - Bcum_s + i_s  (s <= t)
        Dmat = Bcum[..., :, None] - Bcum[..., None, :] + ij[..., None, :]
        Dmat = Dmat.masked_fill(above, -math.inf)
        m_intra = Dmat.amax(dim=-1)
        m_inter = m[..., None] + Bcum
        m_t = torch.clamp_min(torch.maximum(m_intra, m_inter), -1e30)

        smat = (qj @ kj.transpose(-1, -2)) * torch.exp(Dmat - m_t[..., None])
        inter_scale = torch.exp(m_inter - m_t)
        h_num = smat @ vj + (qj @ C) * inter_scale[..., None]
        denom = (smat.sum(dim=-1)
                 + (qj @ n[..., None])[..., 0] * inter_scale)
        denom = torch.maximum(denom.abs(), torch.exp(-m_t))
        hs.append(h_num / denom[..., None])

        # state update to the end of the chunk
        last = Bcum[..., -1]
        m_next = torch.maximum(m + last,
                               (last[..., None] - Bcum + ij).amax(dim=-1))
        w_state = torch.exp(m + last - m_next)                # (B, H)
        w_tok = torch.exp(last[..., None] - Bcum + ij - m_next[..., None])
        kw = kj * w_tok[..., None]
        C = C * w_state[..., None, None] + kw.transpose(-1, -2) @ vj
        n = n * w_state[..., None] + kw.sum(dim=-2)
        # the JAX package shards B over dp and the value dim over tp
        C = constrain_dims(C, mesh_axes, ("dp", None, None, "tp"))
        n = constrain_dims(n, mesh_axes, ("dp", None, "tp"))
        m = m_next
    return torch.cat(hs, dim=2)


def mlstm_recurrent_step(state, q_t, k_t, v_t, i_pre, logf):
    """One decode step. state: (C (B,H,D,D), n (B,H,D), m (B,H)) f32;
    q/k/v_t: (B,H,D) (q pre-scaled); i_pre/logf: (B,H)."""
    C, n, m = state
    m_new = torch.maximum(logf + m, i_pre)
    f_s = torch.exp(logf + m - m_new)[..., None]
    i_s = torch.exp(i_pre - m_new)[..., None]
    kf, vf = k_t.float(), v_t.float()
    C_new = (C * f_s[..., None]
             + i_s[..., None] * kf[..., :, None] * vf[..., None, :])
    n_new = n * f_s + i_s * kf
    qf = q_t.float()
    h_num = (qf[..., None, :] @ C_new)[..., 0, :]
    denom = torch.maximum((qf * n_new).sum(dim=-1).abs(), torch.exp(-m_new))
    return (C_new, n_new, m_new), h_num / denom[..., None]


# --------------------------------------------------------------------------
# block-diagonal projection (official xlstm qkv_proj_blocksize)

def blockdiag_init(gen, dim, blocksize, dtype):
    nb = dim // blocksize
    return {"w": normal_init(gen, (nb, blocksize, blocksize),
                             stddev=1.0 / math.sqrt(blocksize), dtype=dtype)}


def blockdiag_apply(p, x):
    """x: (..., dim) -> block-diagonal linear, dim = nb * bs."""
    nb, bs, _ = p["w"].shape
    xs = x.reshape(x.shape[:-1] + (nb, bs))
    y = torch.einsum("...nb,nbc->...nc", xs, p["w"].to(x.dtype))
    return y.reshape(x.shape)


# --------------------------------------------------------------------------
# mLSTM block

def mlstm_block_init(gen, cfg: XLSTMConfig):
    dt = cfg.pdtype()
    di = cfg.d_inner
    return {
        "norm": rmsnorm_init(gen, cfg.d_model, dtype=dt),
        "up_main": dense_init(gen, cfg.d_model, di, use_bias=False,
                              dtype=dt),
        "up_gate": dense_init(gen, cfg.d_model, di, use_bias=False,
                              dtype=dt),
        "conv": causal_conv_init(gen, di, cfg.conv_kernel, dt),
        "wq": blockdiag_init(gen, di, cfg.qkv_blocksize, dt),
        "wk": blockdiag_init(gen, di, cfg.qkv_blocksize, dt),
        "wv": blockdiag_init(gen, di, cfg.qkv_blocksize, dt),
        "gates": dense_init(gen, di, 2 * cfg.num_heads, use_bias=True,
                            dtype=torch.float32),
        "head_norm": rmsnorm_init(gen, di, dtype=dt),
        "down": dense_init(gen, di, cfg.d_model, use_bias=False, dtype=dt),
    }


def _mlstm_qkv_gates(p, x_in, cfg: XLSTMConfig, conv_out):
    """Shared projection logic. conv_out: (B,S,di) post-conv activations."""
    B, S, _ = conv_out.shape
    H, D = cfg.num_heads, cfg.head_dim

    def heads(a):
        return a.reshape(B, S, H, D).transpose(1, 2)
    q = heads(blockdiag_apply(p["wq"], conv_out))
    k = heads(blockdiag_apply(p["wk"], conv_out))
    v = heads(blockdiag_apply(p["wv"], x_in))
    q = q / math.sqrt(D)
    gates = dense_apply(p["gates"], conv_out.float())        # (B,S,2H) f32
    i_pre = gates[..., :H].transpose(1, 2)                   # (B,H,S)
    logf = F.logsigmoid(gates[..., H:].transpose(1, 2))
    return q, k, v, i_pre.float(), logf.float()


def mlstm_block_apply(p, x, cfg: XLSTMConfig):
    """x: (B, S, d_model) -> (B, S, d_model) residual branch output."""
    B, S, _ = x.shape
    h = rmsnorm_apply(p["norm"], x, eps=cfg.norm_eps)
    main = constrain_dims(dense_apply(p["up_main"], h), cfg.mesh_axes,
                          ("dp", None, "tp"))
    gate = constrain_dims(dense_apply(p["up_gate"], h), cfg.mesh_axes,
                          ("dp", None, "tp"))
    conv_out = F.silu(causal_conv_apply(p["conv"], main))
    q, k, v, i_pre, logf = _mlstm_qkv_gates(p, main, cfg, conv_out)
    hcell = _mlstm_chunk_scan(q, k, v, i_pre, logf,
                              chunk=min(cfg.chunk_len, S),
                              mesh_axes=cfg.mesh_axes)
    hcell = hcell.transpose(1, 2).reshape(B, S, cfg.d_inner)
    hcell = rmsnorm_apply(p["head_norm"], hcell.to(x.dtype),
                          eps=cfg.norm_eps)
    out = dense_apply(p["down"], hcell * F.silu(gate))
    return out.to(x.dtype)


def mlstm_block_step(p, x_t, state, cfg: XLSTMConfig):
    """x_t: (B, 1, d). state: {conv_buf, C, n, m}. Returns (out, state)."""
    B = x_t.shape[0]
    h = rmsnorm_apply(p["norm"], x_t, eps=cfg.norm_eps)[:, 0]    # (B, d)
    main = dense_apply(p["up_main"], h)
    gate = dense_apply(p["up_gate"], h)
    conv_y, new_buf = causal_conv_step(p["conv"], main, state["conv_buf"])
    conv_out = F.silu(conv_y)
    H, D = cfg.num_heads, cfg.head_dim
    q = blockdiag_apply(p["wq"], conv_out).reshape(B, H, D) / math.sqrt(D)
    k = blockdiag_apply(p["wk"], conv_out).reshape(B, H, D)
    v = blockdiag_apply(p["wv"], main).reshape(B, H, D)
    gates = dense_apply(p["gates"], conv_out.float())
    i_pre = gates[..., :H].float()
    logf = F.logsigmoid(gates[..., H:]).float()
    (C, n, m), hcell = mlstm_recurrent_step(
        (state["C"], state["n"], state["m"]), q, k, v, i_pre, logf)
    hcell = hcell.reshape(B, cfg.d_inner).to(x_t.dtype)
    hcell = rmsnorm_apply(p["head_norm"], hcell, eps=cfg.norm_eps)
    out = dense_apply(p["down"], hcell * F.silu(gate))
    return out[:, None].to(x_t.dtype), \
        {"conv_buf": new_buf, "C": C, "n": n, "m": m}


def mlstm_state_init(cfg: XLSTMConfig, batch, device=None):
    H, D = cfg.num_heads, cfg.head_dim
    f32 = torch.float32
    return {
        "conv_buf": torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_inner),
                                dtype=cfg.cdtype(), device=device),
        "C": torch.zeros((batch, H, D, D), dtype=f32, device=device),
        "n": torch.zeros((batch, H, D), dtype=f32, device=device),
        "m": torch.full((batch, H), -1e30, dtype=f32, device=device),
    }


# --------------------------------------------------------------------------
# sLSTM block

def slstm_block_init(gen, cfg: XLSTMConfig):
    dt = cfg.pdtype()
    d = cfg.d_model
    H = cfg.num_heads
    Dh = d // H
    dff = int(d * cfg.slstm_ff_factor)
    p = {"norm": rmsnorm_init(gen, d, dtype=dt),
         "head_norm": rmsnorm_init(gen, d, dtype=dt)}
    for g in GATES:
        p[f"w_{g}"] = dense_init(gen, d, d, use_bias=True, dtype=dt)
        p[f"r_{g}"] = normal_init(gen, (H, Dh, Dh),
                                  stddev=1.0 / math.sqrt(Dh), dtype=dt)
    p["ff_norm"] = rmsnorm_init(gen, d, dtype=dt)
    p["ff_up"] = dense_init(gen, d, 2 * dff, use_bias=False, dtype=dt)
    p["ff_down"] = dense_init(gen, dff, d, use_bias=False, dtype=dt)
    return p


def _slstm_cell_step(p, carry, x_pre):
    """carry: (c, n, m, h) each (B, H, Dh) f32; x_pre: dict gate -> (B, H,
    Dh) input preactivations."""
    c, n, m, h = carry
    rec = {g: torch.einsum("bhd,hde->bhe", h, p[f"r_{g}"].float())
           for g in GATES}
    i_pre = x_pre["i"] + rec["i"]
    f_pre = x_pre["f"] + rec["f"]
    z = torch.tanh(x_pre["z"] + rec["z"])
    o = torch.sigmoid(x_pre["o"] + rec["o"])
    logf = F.logsigmoid(f_pre)
    m_new = torch.maximum(logf + m, i_pre)
    i_s = torch.exp(i_pre - m_new)
    f_s = torch.exp(logf + m - m_new)
    c_new = f_s * c + i_s * z
    n_new = torch.clamp_min(f_s * n + i_s, 1e-6)
    h_new = o * (c_new / n_new)
    return (c_new, n_new, m_new, h_new)


def _slstm_out(p, x, hcell, cfg: XLSTMConfig):
    """Head norm, residual and the GeGLU post-FFN (pf 4/3) around the cell
    output ``hcell`` (B, S, d); returns the residual-branch delta."""
    hcell = rmsnorm_apply(p["head_norm"], hcell.to(x.dtype),
                          eps=cfg.norm_eps)
    out = x + hcell
    hf = rmsnorm_apply(p["ff_norm"], out, eps=cfg.norm_eps)
    a, b = dense_apply(p["ff_up"], hf).chunk(2, dim=-1)
    ff = dense_apply(p["ff_down"], F.gelu(a, approximate="tanh") * b)
    return (out + ff - x).to(x.dtype)


def slstm_block_apply(p, x, cfg: XLSTMConfig):
    """x: (B, S, d) -> (B, S, d). Sequential over time: K8, or a loop of
    the cell step."""
    B, S, d = x.shape
    H = cfg.num_heads
    Dh = d // H
    hin = rmsnorm_apply(p["norm"], x, eps=cfg.norm_eps)
    pre = {g: constrain_dims(
        dense_apply(p[f"w_{g}"], hin).float().reshape(B, S, H, Dh),
        cfg.mesh_axes, ("dp", None, None, "tp")) for g in GATES}

    if cfg.slstm_impl == "kernel":
        # the whole time loop in one launch, state on chip
        R = torch.stack([p[f"r_{g}"].float() for g in GATES])
        hs = slstm_ops.slstm_scan(pre["i"], pre["f"], pre["z"], pre["o"], R)
        return _slstm_out(p, x, hs.reshape(B, S, d), cfg)

    rp = {f"r_{g}": p[f"r_{g}"].float() for g in GATES}
    zero = torch.zeros((B, H, Dh), dtype=torch.float32, device=x.device)
    carry = (zero, zero + 1e-6, zero - 1e30, zero)
    hs = []
    for t in range(S):
        carry = _slstm_cell_step(rp, carry, {g: pre[g][:, t] for g in GATES})
        hs.append(carry[3])
    return _slstm_out(p, x, torch.stack(hs, dim=1).reshape(B, S, d), cfg)


def slstm_block_step(p, x_t, state, cfg: XLSTMConfig):
    B = x_t.shape[0]
    d = cfg.d_model
    H = cfg.num_heads
    Dh = d // H
    hin = rmsnorm_apply(p["norm"], x_t, eps=cfg.norm_eps)[:, 0]
    pre = {g: dense_apply(p[f"w_{g}"], hin).float().reshape(B, H, Dh)
           for g in GATES}
    carry = (state["c"], state["n"], state["m"], state["h"])
    c, n, m, h = _slstm_cell_step(p, carry, pre)
    delta = _slstm_out(p, x_t, h.reshape(B, 1, d), cfg)
    return delta, {"c": c, "n": n, "m": m, "h": h}


def slstm_state_init(cfg: XLSTMConfig, batch, device=None):
    H = cfg.num_heads
    Dh = cfg.d_model // H
    zero = torch.zeros((batch, H, Dh), dtype=torch.float32, device=device)
    return {"c": zero, "n": zero + 1e-6, "m": zero - 1e30, "h": zero}


# --------------------------------------------------------------------------
# full model

def _is_slstm(cfg, p_idx):
    return p_idx == cfg.slstm_every - 1


def init(gen, cfg: XLSTMConfig):
    """Parameters drawn from ``gen`` on its device (a CUDA generator makes
    them on the card). Groups are written one at a time into the stacked
    leaves, so the peak is the model plus one group."""
    G = cfg.slstm_every
    if cfg.num_layers % G:
        raise ValueError(f"num_layers {cfg.num_layers} is not a multiple of "
                         f"slstm_every {G}")
    num_groups = cfg.num_layers // G
    params = {
        "embed": embedding_init(gen, cfg.vocab_size, cfg.d_model,
                                dtype=cfg.pdtype()),
        "final_norm": rmsnorm_init(gen, cfg.d_model, dtype=cfg.pdtype()),
    }

    def one_group():
        return {f"sub{p}": (slstm_block_init if _is_slstm(cfg, p)
                            else mlstm_block_init)(gen, cfg)
                for p in range(G)}

    group = one_group()
    layers = tree_map(lambda a: a.new_empty((num_groups,) + a.shape), group)
    for g in range(num_groups):
        if g:
            group = one_group()
        tree_map(lambda dst, src, g=g: dst[g].copy_(src), layers, group)
    params["layers"] = layers
    return params


def _cast(tree, cfg: XLSTMConfig):
    """Every float leaf in the compute dtype (the f32 gate weights too)."""
    cd = cfg.cdtype()
    return tree_map(lambda a: a.to(cd) if a.is_floating_point() else a, tree)


def _block(params, g, p_idx):
    """Block ``p_idx`` of group ``g``: views into the stacked leaves."""
    return tree_map(lambda a: a[g], params["layers"][f"sub{p_idx}"])


def unembed(params, x, cfg: XLSTMConfig):
    logits = embedding_attend(params["embed"], x, compute_dtype=cfg.cdtype())
    return constrain_act(logits, cfg, kind="logits")


def forward(params, batch_in, cfg: XLSTMConfig, *, training=False,
            return_hidden=False, last_token_only=False):
    """batch_in: {tokens (B, S)} -> (logits f32, aux 0). ``training``
    changes no value;
    ``last_token_only`` keeps the final position (serving prefill);
    ``return_hidden`` returns the final-norm output instead of logits."""
    del training
    x = embedding_apply(params["embed"], batch_in["tokens"],
                        compute_dtype=cfg.cdtype())
    G = cfg.slstm_every
    for g in range(cfg.num_layers // G):
        for p_idx in range(G):
            lp = _cast(_block(params, g, p_idx), cfg)
            apply = (slstm_block_apply if _is_slstm(cfg, p_idx)
                     else mlstm_block_apply)
            x = x + apply(lp, x, cfg)
        x = constrain_act(x, cfg)
    x = rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    if last_token_only:
        x = x[:, -1:]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return unembed(params, x, cfg).float(), aux


def loss_fn(params, batch_in, cfg: XLSTMConfig, *, training=True):
    """Mean next-token cross-entropy of ``batch_in["labels"]`` through
    ``chunked_lm_loss``; returns ``(loss, {"xent"})``."""
    hidden, _ = forward(params, batch_in, cfg, training=training,
                        return_hidden=True)
    loss = chunked_lm_loss(hidden, batch_in["labels"],
                           lambda xc: unembed(params, xc, cfg))
    return loss, {"xent": loss}


def init_decode_state(cfg: XLSTMConfig, batch, max_len=None, *, dtype=None,
                      device=None):
    """Per-block recurrent states stacked on a leading ``num_groups`` axis;
    O(1) in the sequence length (``max_len`` and ``dtype`` are unused)."""
    del max_len, dtype
    G = cfg.slstm_every
    num_groups = cfg.num_layers // G
    state = {}
    for p_idx in range(G):
        one = (slstm_state_init if _is_slstm(cfg, p_idx)
               else mlstm_state_init)(cfg, batch, device)
        state[f"sub{p_idx}"] = tree_map(
            lambda a: a[None].repeat((num_groups,) + (1,) * a.dim()), one)
    return state


def decode_step(params, state, tokens, cfg: XLSTMConfig, *, cur_pos=None):
    """tokens: (B, 1). Writes the new per-block states into ``state`` in
    place and returns (logits (B, 1, V) f32, state). Position-free."""
    del cur_pos
    x = embedding_apply(params["embed"], tokens, compute_dtype=cfg.cdtype())
    G = cfg.slstm_every
    for g in range(cfg.num_layers // G):
        for p_idx in range(G):
            lp = _cast(_block(params, g, p_idx), cfg)
            stacked = state[f"sub{p_idx}"]
            step = (slstm_block_step if _is_slstm(cfg, p_idx)
                    else mlstm_block_step)
            delta, new = step(lp, x, {k: a[g] for k, a in stacked.items()},
                              cfg)
            for k, a in new.items():
                stacked[k][g].copy_(a)
            x = x + delta
    x = rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    logits = embedding_attend(params["embed"], x, compute_dtype=cfg.cdtype())
    return logits.float(), state
