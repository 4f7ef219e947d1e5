"""Evaluation under the paper's three scenarios and two BN policies.

  * testing IID: mixed-class batches through the global model (after
    FedAvg the client copies agree except for BN), client 0's copy;
  * testing non-IID: single-class batches, class k through client k's
    portion (with client k's local BN);
  * RMSD: BatchNorm uses the running statistics at inference;
  * CMSD: BatchNorm uses the test batch's own statistics.
"""
from __future__ import annotations

import torch

from repro_torch.metrics.classification import classification_report
from repro_torch.tree import tree_leaves, tree_map


@torch.no_grad()
def _predict_split(split, cp, cbn, sp, sbn, x, rmsd):
    # RMSD/CMSD applies to the CLIENT-side portion only (paper §VII-A);
    # the server model always uses its running statistics.
    a, _ = split.client_fwd(cp, cbn, x, False, rmsd)
    zeros = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    _, (_, logits) = split.server_loss(sp, sbn, a, zeros, False, True)
    return logits.argmax(dim=-1)


def _batches(x, y, batch):
    batch = min(batch, x.shape[0])
    n = (x.shape[0] // batch) * batch
    return x[:n].split(batch), y[:n].reshape(-1)


def evaluate_split_iid(st, split, test_x, test_y, num_classes, *,
                       rmsd=True, batch=256, client_idx=0):
    """IID test batches through the shared global model (client 0)."""
    cp = tree_map(lambda a: a[client_idx], st["cp"])
    cbn = tree_map(lambda a: a[client_idx], st["cbn"])
    xs, ys = _batches(test_x, test_y, batch)
    preds = torch.cat([_predict_split(split, cp, cbn, st["sp"], st["sbn"],
                                      x, rmsd) for x in xs])
    return classification_report(preds, ys, num_classes)


def evaluate_split_noniid(st, split, test_x, test_y, num_classes, *,
                          rmsd=False, batch=100):
    """Single-class batches: class k evaluated through client k's portion."""
    preds_all, labels_all = [], []
    for k in range(num_classes):
        xk = test_x[test_y == k]
        nb = max(1, xk.shape[0] // batch)
        cp = tree_map(lambda a: a[min(k, a.shape[0] - 1)], st["cp"])
        cbn = tree_map(lambda a: a[min(k, a.shape[0] - 1)], st["cbn"])
        for b in range(nb):
            xb = xk[b * batch:(b + 1) * batch]
            if xb.shape[0] == 0:
                continue
            preds_all.append(_predict_split(split, cp, cbn, st["sp"],
                                            st["sbn"], xb, rmsd))
            labels_all.append(torch.full((xb.shape[0],), k,
                                         dtype=torch.long, device=xb.device))
    return classification_report(torch.cat(preds_all),
                                 torch.cat(labels_all), num_classes)


@torch.no_grad()
def evaluate_fl(st, split, test_x, test_y, num_classes, *, rmsd=True,
                batch=256, client_idx=0):
    p = tree_map(lambda a: a[client_idx], st["p"])
    bn = tree_map(lambda a: a[client_idx], st["bn"])
    xs, ys = _batches(test_x, test_y, batch)
    preds = []
    for x in xs:
        zeros = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
        _, (_, logits) = split.full_loss(p, bn, x, zeros, False, rmsd)
        preds.append(logits.argmax(dim=-1))
    return classification_report(torch.cat(preds), ys, num_classes)


def weight_divergence(w_a, w_b):
    """Paper Eq. (11): ||w_a - w_b|| / ||w_b|| over the flattened tree."""
    fa = torch.cat([x.reshape(-1) for x in tree_leaves(w_a)])
    fb = torch.cat([x.reshape(-1) for x in tree_leaves(w_b)])
    return torch.linalg.norm(fa - fb) / torch.linalg.norm(fb).clamp_min(
        1e-12)
