"""SFPL as a feature of the LM training loop.

Each batch row plays the role of a client holding positive-only data; the
cut after ``cut_groups`` layer groups is the client/server model boundary;
the global-collector shuffle is a batch permutation of the smashed data;
the de-shuffling gradient routing of Algorithm 1 is autograd's backward
of that row gather.

RMSNorm carries no running statistics, so the RMSD/CMSD distinction of
the ResNet path does not arise here.
"""
from __future__ import annotations

import torch


def sfpl_lm_loss(model, params, batch_in, cfg, *, perm, cut_groups=1,
                 training=True):
    """Loss with the SFPL collector shuffle at the cut layer.

    ``model`` is a module exposing ``forward(params, batch, cfg, ...,
    collector_perm=, cut_groups=)`` and ``unembed``. Labels are permuted
    to follow their smashed data (the paper ships (A_k, Y_k) pairs
    through the collector together). Returns ``(loss, {"xent", "aux"})``.
    """
    from repro_torch.models.common import chunked_lm_loss, take_rows

    hidden, aux = model.forward(params, batch_in, cfg, training=training,
                                collector_perm=perm, cut_groups=cut_groups,
                                return_hidden=True)
    labels = batch_in["labels"]
    labels = take_rows(labels, perm)
    loss = chunked_lm_loss(hidden, labels,
                           lambda xc: model.unembed(params, xc, cfg))
    coef = getattr(cfg, "router_aux_coef", 0.0)
    return loss + coef * aux, {"xent": loss, "aux": aux}


def make_collector_perm(gen, global_batch):
    """A uniform permutation of the batch rows, drawn from ``gen`` on its
    device."""
    return torch.randperm(global_batch, generator=gen, device=gen.device)
