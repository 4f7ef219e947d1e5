"""Synthetic LM token streams for the smoke tests and the LM training
example (a learnable k-th order Markov source)."""
from __future__ import annotations

import torch


def synthetic_token_stream(gen, *, batch, seq_len, vocab, order=2,
                           device=None):
    """Markov chain ``next = (3*prev + 5*prev2 + offset + 7) % vocab`` with
    per-stream offsets; learnable by any LM. The start tokens ``x0`` and
    the offsets are drawn from ``gen`` on its device, the recurrence runs
    there, and the result moves to ``device`` (default: ``gen``'s).
    Returns ``(tokens, labels)``, each (batch, seq_len) int32, the labels
    the tokens shifted by one."""
    x0 = torch.randint(0, vocab, (batch, order), generator=gen,
                       device=gen.device)
    offset = torch.randint(0, vocab, (batch, 1), generator=gen,
                           device=gen.device)
    prev = x0
    toks = []
    for _ in range(seq_len + 1):
        nxt = (3 * prev[:, -1] + 5 * prev[:, -2] + offset[:, 0] + 7) % vocab
        prev = torch.cat([prev[:, 1:], nxt[:, None]], dim=1)
        toks.append(nxt)
    toks = torch.stack(toks, dim=1).to(torch.int32)      # (B, S + 1)
    if device is not None:
        toks = toks.to(device)
    return toks[:, :-1], toks[:, 1:]
