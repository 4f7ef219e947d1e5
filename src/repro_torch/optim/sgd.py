"""Optimizers as (init, update) pairs over parameter trees.

The paper trains with SGD: lr 1e-1, momentum 0.9, weight decay 5e-4. The
update is functional (new trees out, inputs untouched) so the round engine
can gate an absent client's step back to its old state. Weight decay is
added to the gradient before the momentum, as in the JAX package. AdamW
is provided for LM training.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.trace import spanned
from repro_torch.tree import tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable     # (grads, opt_state, params, step) -> (new_p, new_s)


def sgd_momentum(lr, *, momentum=0.9, weight_decay=0.0, nesterov=False,
                 state_dtype=None):
    """lr: float or schedule fn(step) -> float. ``nesterov`` steps along
    ``g + momentum * mu_new``; ``state_dtype`` (a torch dtype) stores the
    momentum in that dtype (default: the param's), updated in f32."""
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params):
        return {"mu": tree_map(lambda p: torch.zeros_like(
            p, dtype=state_dtype or p.dtype), params)}

    @spanned("optim.sgd")
    def update(grads, state, params, step):
        lr_t = lr_fn(step)

        def upd(g, mu, p):
            g = g.float()
            if weight_decay:
                g = g + weight_decay * p.float()
            mu_new = momentum * mu.float() + g
            d = (g + momentum * mu_new) if nesterov else mu_new
            p_new = p.float() - lr_t * d
            return p_new.to(p.dtype), mu_new.to(mu.dtype)

        out = tree_map(upd, grads, state["mu"], params)    # (p, mu) leaves
        return (tree_map(lambda t: t[0], out),
                {"mu": tree_map(lambda t: t[1], out)})

    return Optimizer(init, update)


def adamw(lr, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
          state_dtype=None):
    """lr: float or schedule fn(step) -> float. The moments are stored in
    ``state_dtype`` (default f32) and updated in f32; bias correction
    uses ``t = step + 1`` in f32; the decoupled weight decay is added to
    the step direction, as in the JAX package."""
    lr_fn = lr if callable(lr) else (lambda step: lr)

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=state_dtype or torch.float32)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    @spanned("optim.adamw")
    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        t = torch.as_tensor(step, dtype=torch.float32) + 1.0
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t

        def upd(g, m, v, p):
            g = g.float()
            m_new = b1 * m.float() + (1 - b1) * g
            v_new = b2 * v.float() + (1 - b2) * g * g
            mhat = m_new / c1        # c1, c2: 0-dim f32 scalars
            vhat = v_new / c2
            d = mhat / (torch.sqrt(vhat) + eps)
            if weight_decay:
                d = d + weight_decay * p.float()
            p_new = p.float() - lr_t * d
            return p_new.to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)

        out = tree_map(upd, grads, state["m"], state["v"], params)
        pick = lambda i: tree_map(lambda o: o[i], out)
        return pick(0), {"m": pick(1), "v": pick(2)}

    return Optimizer(init, update)
