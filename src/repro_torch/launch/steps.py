"""Step functions (train / prefill / decode) shared by training, serving
and their checks."""
from __future__ import annotations

from repro_torch.tree import grads as tree_grads, with_grad


def make_train_step(spec, cfg, optimizer, *, sfpl=False, cut_groups=1):
    """Returns ``train_step(params, opt_state, step, batch) -> (params,
    opt_state, step + 1, loss)``: the gradient of the model's loss, then
    ``optimizer.update``.

    With ``sfpl=True`` (transformer family) the batch dict must contain
    "perm", the global-collector permutation: the smashed data is
    shuffled at the cut layer inside the step and the gradient de-shuffle
    is the backward of that gather. The xLSTM has no cut: it runs its
    plain loss, as in the JAX package.
    """
    model = spec.model

    def loss_of(params, batch):
        if sfpl and spec.family == "transformer":
            from repro_torch.core.split_lm import sfpl_lm_loss
            return sfpl_lm_loss(model, params, batch, cfg,
                                perm=batch["perm"], cut_groups=cut_groups)
        clean = {k: v for k, v in batch.items() if k != "perm"}
        return model.loss_fn(params, clean, cfg, training=True)

    def train_step(params, opt_state, step, batch):
        p = with_grad(params)
        loss, _ = loss_of(p, batch)
        new_params, new_opt = optimizer.update(tree_grads(loss, p),
                                               opt_state, params, step)
        return new_params, new_opt, step + 1, loss.detach()

    return train_step


def make_prefill_step(spec, cfg):
    model = spec.model

    def prefill_step(params, batch):
        # serving prefill: only the final position's logits seed decode;
        # (B, S, V) logits would dominate memory
        logits, _ = model.forward(params, batch, cfg, training=False,
                                  last_token_only=True)
        return logits

    return prefill_step


def make_decode_step(spec, cfg):
    model = spec.model

    def decode_step(params, state, tokens, cur_pos):
        return model.decode_step(params, state, tokens, cfg,
                                 cur_pos=cur_pos)

    return decode_step
