"""Step functions (prefill / decode) shared by serving and its checks.

``make_train_step`` (LM training) belongs to the LM-training slice of the
port.
"""
from __future__ import annotations


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
