"""Three-term roofline from the dry run.

Method. The JAX package lowers each (arch, shape) at 1 and 2 layer units
because ``cost_analysis()`` counts a ``lax.scan`` body once; the port
keeps the same 1-unit / 2-unit extrapolation, which bounds the trace
time (an eager trace counts every layer it runs, so the extrapolation is
exact):

    total = cost(1u) + (cost(2u) - cost(1u)) * (num_units - 1)

The JAX package also adds back the kv-chunk scan inside long-sequence
attention, which its cost analysis counts once. The port's attention
loops over the kv chunks in Python (``nn/attention.py::
_attention_chunks``), so the trace counts every chunk and the correction
is 0.0 on every shape.

Hardware model: one NVIDIA H100 80GB HBM3 (SXM5, 700 W) a device, at its
datasheet rates: 989e12 dense bf16 FLOP/s and 3.35e12 B/s of HBM3. The
network term uses 50e9 B/s, the 400 Gb/s InfiniBand NDR link a GPU has
off its 8-GPU node: every mesh axis of 16 devices crosses nodes. Within
a node NVLink moves 450 GB/s a direction; the model does not use it.

    compute term    = FLOPs_per_device / peak_flops
    memory term     = bytes_per_device / hbm_bw
    collective term = collective_traffic_per_device / net_bw
"""
from __future__ import annotations

import math

HW = {
    "peak_flops": 989e12,   # dense bf16 per H100 SXM5
    "hbm_bw": 3.35e12,      # bytes/s, HBM3
    "net_bw": 50e9,         # bytes/s per GPU, 400 Gb/s InfiniBand NDR
}


def _family_units(spec, cfg):
    """(num_units, base_overrides, double_overrides) for the extrapolation."""
    fam = spec.family
    if fam == "transformer":
        G = cfg.group_size
        n = cfg.num_layers // G
        return n, {"num_layers": G}, {"num_layers": 2 * G}
    if fam == "xlstm":
        G = cfg.slstm_every
        n = cfg.num_layers // G
        return n, {"num_layers": G}, {"num_layers": 2 * G}
    if fam == "rglru":
        pat = len(cfg.pattern)
        trail = cfg.num_layers % pat
        n = cfg.num_layers // pat
        return n, {"num_layers": pat + trail}, {"num_layers": 2 * pat + trail}
    if fam == "whisper":
        return cfg.num_layers, {"num_layers": 1}, {"num_layers": 2}
    raise ValueError(fam)


def active_params(spec, cfg):
    """Active parameter count (MoE: 1-of-E routed + shared + dense), from
    an init on the meta device."""
    import torch
    from repro_torch.tree import tree_map_with_path
    with torch.device("meta"):
        params = spec.model.init(None, cfg)
    counts = []

    def one(path, leaf):
        names = [str(k) for k in path]
        n = math.prod(leaf.shape)
        if "moe" in names and names[names.index("moe") + 1] in \
                ("wi", "wg", "wo"):
            n = n / cfg.num_experts     # top-1: one expert active
        counts.append(n)
    tree_map_with_path(one, params)
    return float(sum(counts))


def attention_flops_global(spec, cfg, shape):
    """Closed-form attention FLOPs (fwd; x3 for training) across layers."""
    B, S = shape.global_batch, shape.seq_len
    if spec.family == "xlstm":
        return 0.0   # mLSTM chunk form counted by the trace
    if spec.family == "whisper":
        St = min(448, S)
        enc = 4 * B * cfg.num_heads * cfg.head_dim * S * S
        dec = 4 * B * cfg.num_heads * cfg.head_dim * (0.5 * St * St + St * S)
        return cfg.num_layers * (enc + dec)
    H, D = cfg.num_heads, cfg.head_dim
    total = 0.0
    num_layers = cfg.num_layers
    for idx in range(num_layers):
        if spec.family == "rglru":
            full = (cfg.num_layers // len(cfg.pattern)) * len(cfg.pattern)
            pat = cfg.pattern[idx % len(cfg.pattern)] if idx < full \
                else cfg.pattern[:cfg.num_trailing][idx % len(cfg.pattern)]
            if pat != "attn":
                continue
            window = cfg.window
        else:
            kind = cfg.layer_kind(idx % cfg.group_size)
            window = kind["window"]
        if shape.kind == "decode":
            kv = min(S, window or S)
            total += 4 * B * H * D * kv          # one new token
            continue
        if window is None:
            eff = 0.5 * S * S                    # causal
        else:
            w = min(window, S)
            eff = w * S - 0.5 * w * w            # causal + window
        total += 4 * B * H * D * eff
    if shape.kind == "train":
        total *= 3.0                             # fwd + 2x bwd
    return total


def roofline_terms(base, double, num_units, *, devices, shape, spec, cfg):
    """base/double: result dicts from ``dryrun.lower_one`` at 1 and 2
    layer units."""
    def lin(f1, f2):
        return f1 + (f2 - f1) * (num_units - 1)

    flops = lin(base["cost"]["flops"] or 0, double["cost"]["flops"] or 0)
    bytes_ = lin(base["cost"]["bytes_accessed"] or 0,
                 double["cost"]["bytes_accessed"] or 0)

    coll = {}
    keys = set(base["collectives"]) | set(double["collectives"])
    for k in keys:
        b = base["collectives"].get(k, {"traffic_bytes": 0, "count": 0})
        d = double["collectives"].get(k, {"traffic_bytes": 0, "count": 0})
        coll[k] = lin(b["traffic_bytes"], d["traffic_bytes"])
    coll_bytes = sum(coll.values())

    terms = {
        "flops_per_dev": flops,
        "bytes_per_dev": bytes_,
        "coll_bytes_per_dev": coll_bytes,
        "coll_breakdown": coll,
        # the trace counts every kv chunk: nothing to add back
        "attn_flops_correction": 0.0,
        "compute_s": flops / HW["peak_flops"],
        "memory_s": bytes_ / HW["hbm_bw"],
        "collective_s": coll_bytes / HW["net_bw"],
    }
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["dominant"] = dom.replace("_s", "")

    # MODEL_FLOPS = 6 N_active D (train) / 2 N D (inference fwd)
    n_act = active_params(spec, cfg)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    mf_coef = 6.0 if shape.kind == "train" else 2.0
    model_flops = mf_coef * n_act * tokens
    terms["model_flops_global"] = model_flops
    terms["hlo_flops_global"] = flops * devices
    terms["useful_ratio"] = (model_flops / max(terms["hlo_flops_global"], 1)
                             if flops else 0.0)
    return terms


RECOMMENDATIONS = {
    "compute": ("compute-bound: raise the share of bf16 tensor-core work "
                "(a larger batch a device, attention through K7, the "
                "experts' products batched), cut the f32 passes"),
    "memory": ("HBM-bound: fuse norms and elementwise passes (K6's "
               "fused RMSNorm), cast saved activations to bf16, cut "
               "the f32 weight casts a step"),
    "collective": ("network-bound: fewer weight all-gathers (larger FSDP "
                   "shards, replicate small layers), overlap collectives "
                   "with compute, keep the batch's axis inside a node"),
}
