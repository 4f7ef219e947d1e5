"""Classification metrics used by the paper: Precision@1, Recall, F1 and
Accuracy, macro-averaged over classes as in the paper's tables."""
from __future__ import annotations

import torch


def confusion_matrix(preds, labels, num_classes):
    idx = labels.long() * num_classes + preds.long()
    cm = torch.bincount(idx, minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes).float()


def _prf(cm):
    tp = torch.diag(cm)
    precision = tp / cm.sum(dim=0).clamp_min(1e-9)
    recall = tp / cm.sum(dim=1).clamp_min(1e-9)
    f1 = 2 * precision * recall / (precision + recall).clamp_min(1e-9)
    return precision, recall, f1


def _macro(v):
    """Mean over classes as XLA lowers ``jnp.mean``: the sum times the
    reciprocal of the count."""
    return v.sum() * (1.0 / v.numel())


def precision_at_1(preds, labels, num_classes):
    p, _, _ = _prf(confusion_matrix(preds, labels, num_classes))
    return _macro(p)


def recall_macro(preds, labels, num_classes):
    _, r, _ = _prf(confusion_matrix(preds, labels, num_classes))
    return _macro(r)


def f1_macro(preds, labels, num_classes):
    _, _, f = _prf(confusion_matrix(preds, labels, num_classes))
    return _macro(f)


def accuracy(preds, labels):
    return (preds.long() == labels.long()).float().mean()


def classification_report(preds, labels, num_classes):
    cm = confusion_matrix(preds, labels, num_classes)
    p, r, f = _prf(cm)
    return {
        "precision@1": float(p.mean()),
        "recall": float(r.mean()),
        "f1": float(f.mean()),
        "accuracy": float(accuracy(preds, labels)) * 100.0,
        "per_class_acc": torch.diag(cm) / cm.sum(dim=1).clamp_min(1e-9),
    }
