"""The comparison that decides ``correct``: the program's first training
steps against the plain reference's, on the same weights, images and
permutations.

``numbers`` gives every reading; a cell's ``bench/workloads/<cell>.json``
picks the ones compared, each with its limit, and keeps the readings the
limits were set from beside them:

* ``loss_gap``: the worst over the checked steps of ``|loss - ref| /
  |ref|`` (``loss1_gap``: the first step's alone);
* ``head_grad_err``: the classifier's first gradient as the optimizer
  takes it (its momentum after one step: gradient plus weight decay),
  ``‖prog - ref‖ / ‖ref‖`` at the worse of its weight and its bias
  (``head_w_err``, ``head_b_err``);
* ``grad_gap`` / ``grad_median_gap``: that first gradient by leaf, the
  gap between the two norms of a leaf over the larger of the reference's
  norm of that leaf and of the median leaf, at the worst leaf / the median
  leaf;
* ``bn_var_err``: the batch variance every server BatchNorm saw in the
  first step (the program's recovered from its running statistics),
  ``‖prog - ref‖ / ‖ref‖`` at the median layer (``bn1_var_err``: at
  the first, whose input is the shuffled pool's first conv);
* ``update_gap`` / ``update_median_gap``: the parameters' change over the
  checked steps (FedAvg included), by leaf, measured alike;
* ``nonfinite``: losses of the measured window that are not finite
  (``run.py`` adds it; limit 0).

Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the leaf numbers: they move by round-off alone.
A client leaf is one leaf over all clients.
"""
from __future__ import annotations

import statistics

import torch

NEGLIGIBLE = 1e-3
HEAD = ("server.fc.w", "server.fc.b")


def _norms(tree):
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def leaf_gaps(got, want, keep):
    """Per leaf, ``|‖got‖ - ‖want‖| / max(‖want‖, median ‖want‖)``."""
    g, w = _norms(got), _norms(want)
    med = statistics.median(w[k] for k in keep)
    return [abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in keep]


def numbers(prog, ref):
    """Every reading of the program's against the reference's
    ``{"losses", "first_mu", "first_var", "start", "params"}``; a cell's
    limits pick
    the ones it compares."""
    gnorm = _norms(ref["first_mu"])
    med = statistics.median(gnorm.values())
    keep = [k for k, v in gnorm.items() if v >= NEGLIGIBLE * med]
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        rel = [float("inf")]
    delta = lambda run: {k: run["params"][k].double() - run["start"][k]
                         .double() for k in keep}
    grad = leaf_gaps(prog["first_mu"], ref["first_mu"], keep)
    upd = leaf_gaps(delta(prog), delta(ref), keep)
    head = [float(torch.linalg.vector_norm(prog["first_mu"][k].double()
                                           - ref["first_mu"][k].double())
                  / torch.linalg.vector_norm(ref["first_mu"][k].double()))
            for k in HEAD]
    bn = [float(torch.linalg.vector_norm(prog["first_var"][k].double()
                                         - ref["first_var"][k].double())
                / torch.linalg.vector_norm(ref["first_var"][k].double()))
          for k in ref["first_var"]]
    return {"loss_gap": max(rel), "loss1_gap": rel[0],
            "bn_var_err": statistics.median(bn), "bn1_var_err": bn[0],
            "head_grad_err": max(head), "head_w_err": head[0],
            "head_b_err": head[1],
            "grad_gap": max(grad), "grad_median_gap": statistics.median(grad),
            "update_gap": max(upd), "update_median_gap": statistics.median(upd)}


def judge(values, limits):
    """``(correct, checks)``: every number at or under its limit (a NaN
    fails), with each number beside its limit."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits}
    ok = all(values[k] <= limits[k] for k in limits)
    return ok, checks
