"""Feed-forward blocks: SwiGLU / GeGLU when gated, else a plain MLP."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn.linear import dense_init, dense_apply
from repro_torch.sharding.dtensor import gather_rows

ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu default
    "gelu_exact": F.gelu,
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),         # nemotron/minitron
}


def mlp_init(gen, d_model, d_ff, *, gated=True, dtype=torch.float32):
    p = {"wi": dense_init(gen, d_model, d_ff, use_bias=False, dtype=dtype),
         "wo": dense_init(gen, d_ff, d_model, use_bias=False, dtype=dtype)}
    if gated:
        p["wg"] = dense_init(gen, d_model, d_ff, use_bias=False, dtype=dtype)
    return p


def mlp_apply(params, x, *, act="silu"):
    """SwiGLU (act=silu) / GeGLU (act=gelu) when ``wg`` is present, else
    ``act(x @ wi) @ wo``. A sequence-parallel DTensor input is gathered
    once for ``wi`` and ``wg``."""
    x = gather_rows(x)
    h = dense_apply(params["wi"], x)
    if "wg" in params:
        h = ACTS[act](dense_apply(params["wg"], x)) * h
    else:
        h = ACTS[act](h)
    return dense_apply(params["wo"], h)
