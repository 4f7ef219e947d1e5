"""Step functions (train / prefill / decode) shared by training, serving
and their checks."""
from __future__ import annotations

import contextlib

from repro_torch.sharding.dtensor import is_dtensor
from repro_torch.tree import grads as tree_grads, tree_leaves, with_grad

# leaves that no gradient reaches and no optimizer steps: the dropless
# MoE's expert bias, stepped by its own rule after the update
BUFFERS = ("expert_bias",)


def _split(tree):
    """``(trainable, buffers)``: ``tree`` without and with only the leaves
    named in ``BUFFERS`` (empty dicts pruned from the second)."""
    if not isinstance(tree, dict):
        return tree, None
    keep, held = {}, {}
    for k, v in tree.items():
        if k in BUFFERS:
            held[k] = v
            continue
        a, b = _split(v)
        keep[k] = a
        if b:
            held[k] = b
    return keep, held


def _merge(tree, buffers):
    if not buffers:
        return tree
    return {**tree, **{k: (_merge(tree[k], v) if k in tree else v)
                       for k, v in buffers.items()}}


def trainable(params):
    """``params`` without its buffers: what an optimizer is initialised
    on and steps."""
    return _split(params)[0]


def sharded_scope(params):
    """The scope a step runs in: with DTensor params (a sharded step, see
    ``repro_torch.sharding``) the tensors the model makes itself
    (positions, masks, the online softmax's state) count as replicated
    (``implicit_replication``); with plain params, nothing."""
    if not any(is_dtensor(t) for t in tree_leaves(params)):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def make_train_step(spec, cfg, optimizer, *, sfpl=False, cut_groups=None):
    """Returns ``train_step(params, opt_state, step, batch) -> (params,
    opt_state, step + 1, loss)``: the gradient of the model's loss, then
    ``optimizer.update`` of the trainable leaves (``trainable``; the
    optimizer's state is made from them), then each dropless MoE layer's
    expert bias stepped by the token-slots per expert that the forward
    routed (once a step: the counts are read before the backward and its
    recompute).

    With ``sfpl=True`` (transformer family) the batch dict must contain
    "perm", the global-collector permutation: the smashed data is
    shuffled at the cut inside the step and the gradient de-shuffle is
    the backward of that gather. The cut follows ``cut_groups`` units
    (``models.transformer.units``); by default the leading dense layers,
    or else one group. The xLSTM has no cut: it runs its plain loss, as
    in the JAX package.
    """
    from repro_torch.nn.moe import record_routing

    model = spec.model
    if cut_groups is None:
        cut_groups = getattr(cfg, "num_dense_layers", 0) or 1

    def loss_of(params, batch):
        if sfpl and spec.family == "transformer":
            from repro_torch.core.split_lm import sfpl_lm_loss
            return sfpl_lm_loss(model, params, batch, cfg,
                                perm=batch["perm"], cut_groups=cut_groups)
        clean = {k: v for k, v in batch.items() if k != "perm"}
        return model.loss_fn(params, clean, cfg, training=True)

    def train_step(params, opt_state, step, batch):
        params, buffers = _split(params)
        with sharded_scope(params):
            p = with_grad(params)
            with record_routing() as routes:
                loss, _ = loss_of(_merge(p, buffers), batch)
            new_params, new_opt = optimizer.update(tree_grads(loss, p),
                                                   opt_state, params, step)
        new_params = _merge(new_params, buffers)
        if routes.counts:
            new_params = model.update_expert_bias(new_params, routes.counts,
                                                  cfg)
        return new_params, new_opt, step + 1, loss.detach()

    return train_step


def make_prefill_step(spec, cfg):
    model = spec.model

    def prefill_step(params, batch):
        # serving prefill: only the final position's logits seed decode;
        # (B, S, V) logits would dominate memory
        with sharded_scope(params):
            logits, _ = model.forward(params, batch, cfg, training=False,
                                      last_token_only=True)
        return logits

    return prefill_step


def make_decode_step(spec, cfg):
    model = spec.model

    def decode_step(params, state, tokens, cur_pos):
        with sharded_scope(params):
            return model.decode_step(params, state, tokens, cfg,
                                     cur_pos=cur_pos)

    return decode_step
