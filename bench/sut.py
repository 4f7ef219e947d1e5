"""The system under test: the port's single-device SFPL round.

Everything the benchmark drives of ``repro_torch`` goes through here:
``make_resnet_split(cfg, ComputePolicy(compute_dtype))``,
``DenseTake(num_clients, use_kernel=True)``, ``sgd_momentum`` for clients
and server, and ``core.round.sfpl_round`` with ``bn_mode="cmsd"``. The
weights and images are the benchmark's (``reference.init_params``,
``images.positive_label_cifar``), handed to the program in its own tree
layout; the program builds its state from them.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def import_program():
    """Import the port from ``src/`` of the checkout; raises ImportError
    where there is none."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    import repro_torch.core.engine  # noqa: F401
    import repro_torch.core.round  # noqa: F401
    import repro_torch.models.common  # noqa: F401
    import repro_torch.models.resnet  # noqa: F401
    import repro_torch.optim  # noqa: F401


def _nest(flat, prefix):
    """Flat ``a.b.c`` leaves under ``prefix`` as nested dicts."""
    out = {}
    for name, v in flat.items():
        if not name.startswith(prefix):
            continue
        *path, leaf = name[len(prefix):].split(".")
        d = out
        for key in path:
            d = d.setdefault(key, {})
        d[leaf] = v
    return out


def bn_state(params, prefix):
    """Fresh running statistics for every BatchNorm under ``prefix``."""
    out = {}
    for name, v in params.items():
        if name.startswith(prefix) and name.endswith(".scale"):
            base = name[:-len("scale")]
            out[base + "mean"] = torch.zeros_like(v)
            out[base + "var"] = torch.ones_like(v)
            out[base + "count"] = v.new_zeros(())
    return _nest(out, prefix)


def flatten(tree, prefix=""):
    """Nested dict -> flat ``a.b.c`` leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


class Program:
    """The port's SFPL training on one device, set up from the benchmark's
    weights and data for one configuration and traffic mix."""

    def __init__(self, cfg, traffic, device):
        from repro_torch.core import engine as E
        from repro_torch.core import round as RD
        from repro_torch.models import resnet as R
        from repro_torch.models.common import ComputePolicy
        from repro_torch.optim import sgd_momentum
        model, dep, opt = cfg["model"], cfg["deployment"], cfg["optimizer"]
        self.clients = dep["clients"]
        self.batch = traffic["client_batch"]
        self.device = device
        self.rcfg = R.ResNetConfig(depth=model["depth"],
                                   num_classes=model["num_classes"],
                                   width=model["width"])
        self.split = E.make_resnet_split(self.rcfg, policy=ComputePolicy(
            cfg["precision"]["compute_dtype"]))
        self.opt = sgd_momentum(opt["lr"], momentum=opt["momentum"],
                                weight_decay=opt["weight_decay"])
        self.collector = RD.DenseTake(self.clients, use_kernel=True)
        self.bn_mode = dep["bn_mode"]
        self._E, self._RD = E, RD

    def init_state(self, params):
        """The program's SFPL state from one model's flat float32 leaves
        (the benchmark's): client leaves replicated over the clients,
        fresh BatchNorm statistics, zero momentum."""
        p = {"client": _nest(params, "client."),
             "server": _nest(params, "server.")}
        s = {"client": bn_state(params, "client."),
             "server": bn_state(params, "server.")}
        return self._E.init_dcml_state(None, lambda _: (p, s), self.clients,
                                       self.opt, self.opt)

    def epoch(self, gen, st, data):
        """One SFPL epoch over every batch of ``data``: ``(state,
        losses)``."""
        return self._RD.sfpl_round(
            gen, st, data, self.split, self.opt, self.opt,
            num_clients=self.clients, batch_size=self.batch,
            bn_mode=self.bn_mode, collector=self.collector,
            device=self.device)


def params_of(st):
    """Flat float32 parameter leaves of a program state (client leaves
    stacked), named as ``reference.param_shapes`` names them."""
    return {**flatten(st["cp"], "client."), **flatten(st["sp"], "server.")}


def server_bn_var(st):
    """The server BatchNorms' running variances (copies), named
    ``server.<block>.<bn>.var``."""
    return {k: v.detach().clone()
            for k, v in flatten(st["sbn"], "server.").items()
            if k.endswith(".var")}


def momentum_of(st):
    """Flat momentum leaves of a program state, named as its parameters."""
    return {**flatten(st["copt"]["mu"], "client."),
            **flatten(st["sopt"]["mu"], "server.")}
