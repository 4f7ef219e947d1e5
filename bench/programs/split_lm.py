"""SFPL split-LM training of the port's transformer family (``model.arch``
``split_lm``; the architecture is ``model.arch_id`` of the port's
registry): the normal training step,
``launch/steps.py::make_train_step(spec, cfg, adamw(...), sfpl=True)``,
on the traffic's ``clients`` a step, each one sequence of its
``seq_len`` tokens from its own band of the vocabulary; the
collector's permutation of the client rows at the cut after the leading
dense layers, a fresh one each step.

A unit of the window is one SFPL step; a sample is one client's
sequence. The plain reference is ``split_lm_ref.py`` beside this file,
whose weights (``init_params``) and data (``make_batch``, ``make_perm``)
the program is given, converted into its own tree.

On import, the module points Inductor's cache at the checkout's
``build/inductor/`` (the flex attention's compiles, kept for the next
run) and checks that the port has every field of ``AfmoeConfig`` that
it sets: a tree without them fails here, within seconds.
"""
from __future__ import annotations

import importlib.util
import os
import statistics
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(ROOT / "build" / "inductor")
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models.common import AfmoeConfig  # noqa: E402
from repro_torch.trace import COUNTERS  # noqa: E402

# configuration key -> the port's field
FIELDS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
          "num_attention_heads": "num_heads",
          "num_key_value_heads": "num_kv_heads", "head_dim": "head_dim",
          "moe_intermediate_size": "d_ff",
          "intermediate_size": "d_ff_dense", "vocab_size": "vocab_size",
          "num_dense_layers": "num_dense_layers",
          "num_experts_per_tok": "moe_top_k",
          "route_scale": "route_scale", "sliding_window": "sliding_window",
          "global_attn_every_n_layers": "global_attn_period",
          "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
          "load_balance_coeff": "expert_bias_rate"}
PORT_FIELDS = set(FIELDS.values()) | {"num_experts", "experts_held",
                                      "attention_impl", "remat",
                                      "compute_dtype"}
_missing = PORT_FIELDS - set(AfmoeConfig.__dataclass_fields__)
if _missing:
    raise ImportError(f"the port's AfmoeConfig has no "
                      f"{sorted(_missing)}: it cannot run a split_lm cell")

FAULTS = {"control": {"precision": "fp8"},
          "all_full": {"fault": "all_full"},
          "rope_everywhere": {"fault": "rope_everywhere"},
          "no_attn_gate": {"fault": "no_attn_gate"},
          "no_route_norm": {"fault": "no_route_norm"},
          "top1": {"fault": "top1"},
          "half_batch": {"fault": "half_batch"},
          "half_rows": {"fault": "half_rows"},
          "frozen": {"frozen": True}}
NEGLIGIBLE = 1e-3
HEAD = "unembed.w"


def ref():
    """``split_lm_ref.py`` beside this file, loaded once by its path."""
    path = HERE / "split_lm_ref.py"
    name = f"split_lm_ref_{abs(hash(str(path)))}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def sub_seed(seed, k):
    """The ``k``-th stream of ``seed``: data 0, weights 1, shuffles 2."""
    return (int(seed) * 0x9E3779B97F4A7C15 + k * 0xBF58476D1CE4E5B9) \
        % (2 ** 63)


def port_config(cell, dev):
    """The port's arch spec and config for the cell: every size from the
    configuration file, the experts held from its deployment, the flex
    attention on the card (the plain ``xla`` path on the CPU), the
    precision the file states."""
    c = cell.config
    dep = c["deployment"]
    spec = get_arch(c["model"]["arch_id"])
    kw = {FIELDS[k]: c[k] for k in FIELDS}
    kw["rope_theta"] = float(kw["rope_theta"])
    cfg = spec.make_config(
        **kw, num_experts=dep["router_experts"],
        experts_held=tuple(dep["experts_held"]),
        compute_dtype=c["precision"]["compute_dtype"],
        param_dtype=c["precision"]["param_dtype"],
        attention_impl="flex" if dev.type == "cuda" else "xla", remat=True)
    if cfg.moe_routing != "dropless":
        raise ValueError(f"{spec.arch_id} does not route dropless")
    return spec, cfg


def to_port(rp, cfg):
    """The reference's weights as the port's tree: the leading dense
    layers and the rest each stacked (one layer a group)."""
    from repro_torch.tree import tree_map
    nd = cfg.num_dense_layers
    stack = lambda ls: tree_map(lambda *xs: torch.stack(xs), *ls)
    out = {k: rp[k] for k in ("embed", "unembed", "final_norm")}
    out["dense_layers"] = {"sub0": stack(rp["layers"][:nd])}
    out["layers"] = {"sub0": stack(rp["layers"][nd:])}
    return out


def from_port(tree, cfg, device="cpu"):
    """The port's tree by the reference's ``flat`` names, on ``device``."""
    out = {}

    def walk(t, path, first=None):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,), first)
            return
        if first is None:
            out[".".join(path)] = t.detach().to(device, torch.float32)
            return
        for g in range(t.shape[0]):
            out[".".join(("layers", str(first + g)) + path)] = \
                t[g].detach().to(device, torch.float32)
    for k, v in tree.items():
        if k == "dense_layers":
            walk(v["sub0"], (), 0)
        elif k == "layers":
            walk(v["sub0"], (), cfg.num_dense_layers)
        else:
            walk(v, (k,))
    return out


def _moe_seen():
    """The MoE calls' tokens and held rows so far (``COUNTERS["moe"]``)."""
    c = COUNTERS["moe"]
    return c["tokens"], c["held_rows"]


def _load(before, share):
    """The held experts' rows since ``before`` (``_moe_seen``) over
    ``share`` of the token-slots (top-k x held / experts): 1 where the
    held experts took the even share of the load that expert parallelism
    gives them."""
    tokens, rows = (a - b for a, b in zip(_moe_seen(), before))
    return rows / max(tokens * share, 1)


def _share(cfg):
    return cfg.moe_top_k * cfg.experts_held[1] / cfg.num_experts


def _optimizer(cell):
    o = cell.config["optimizer"]
    return {"lr": o["lr"], "b1": o["b1"], "b2": o["b2"], "eps": o["eps"],
            "weight_decay": o["weight_decay"]}


def _batches(cell, seed, dev, n):
    """The first ``n`` steps' data and permutations, as the window draws
    them: ``(data generator, shuffle generator, [(tokens, labels, perm)])``."""
    R = ref()
    clients = cell.traffic["clients"]
    seq, vocab = cell.traffic["seq_len"], cell.config["vocab_size"]
    data = torch.Generator(dev).manual_seed(sub_seed(seed, 0))
    shuf = torch.Generator(dev).manual_seed(sub_seed(seed, 2))
    out = [(*R.make_batch(data, clients, seq, vocab),
            R.make_perm(shuf, clients)) for _ in range(n)]
    return data, shuf, out


class Runner:
    """The program after its checked steps, driven one step at a time."""

    steps_per_unit = 1

    def __init__(self, cell, step_fn, params, opt_state, step, data, shuf,
                 share, load):
        self.cell, self.step_fn = cell, step_fn
        self.params, self.opt_state, self.step = params, opt_state, step
        self.data, self.shuf = data, shuf
        self.samples_per_unit = cell.traffic["clients"]
        self.share, self.load = share, load

    def unit(self):
        R = ref()
        c = self.cell
        tokens, labels = R.make_batch(self.data, self.samples_per_unit,
                                      c.traffic["seq_len"],
                                      c.config["vocab_size"])
        perm = R.make_perm(self.shuf, self.samples_per_unit)
        before = _moe_seen()
        self.params, self.opt_state, self.step, loss = self.step_fn(
            self.params, self.opt_state, self.step,
            {"tokens": tokens, "labels": labels, "perm": perm})
        self.load.append(_load(before, self.share))
        return loss.reshape(1)

    def free(self):
        self.params = self.opt_state = self.step_fn = None


def checked(cell, seed, dev):
    """Set-up, then the checked steps (the traffic's ``check_epochs``
    summed, one step a unit) through the window's step function and data:
    ``(runner, {"losses", "first_grad", "params", "choices",
    "held_load"})``, the first step's gradient read from AdamW's first
    moment, all on the host; ``held_load`` a step's held rows over their
    even share (``_load``), for the checked steps and then every step
    the runner takes."""
    from repro_torch.launch.steps import make_train_step, trainable
    from repro_torch.nn.moe import record_routing
    from repro_torch.optim import adamw

    spec, cfg = port_config(cell, dev)
    R = ref()
    m = R.dims(cell.config)
    if cell.traffic["check_epochs"][0] != 1:
        raise ValueError("check_epochs must start with one step: the first "
                         "gradient is read from AdamW's first moment")
    opt = _optimizer(cell)
    gen = torch.Generator(dev).manual_seed(sub_seed(seed, 1))
    params = to_port(R.init_params(gen, m), cfg)
    optimizer = adamw(opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
                      weight_decay=opt["weight_decay"])
    opt_state = optimizer.init(trainable(params))
    step_fn = make_train_step(spec, cfg, optimizer, sfpl=True)
    data, shuf, batches = _batches(cell, seed, dev,
                                   sum(cell.traffic["check_epochs"]))
    losses, first_grad, choices, step, load = [], None, None, 0, []
    for tokens, labels, perm in batches:
        before = _moe_seen()
        with record_routing(keep_choices=first_grad is None) as rec:
            params, opt_state, step, loss = step_fn(
                params, opt_state, step,
                {"tokens": tokens, "labels": labels, "perm": perm})
        load.append(_load(before, _share(cfg)))
        losses.append(float(loss))
        if first_grad is None:
            choices = rec.choices[0].cpu()
            first_grad = {k: v / (1 - opt["b1"]) for k, v in
                          from_port(opt_state["m"], cfg).items()}
    out = {"losses": losses, "first_grad": first_grad,
           "params": from_port(params, cfg), "choices": choices,
           "held_load": load}
    return Runner(cell, step_fn, params, opt_state, step, data, shuf,
                  _share(cfg), load), out


def reference(cell, seed, dev, fault=None, precision="float32",
              frozen=False):
    """The plain reference through the checked steps from the same
    weights, data and permutations: the program's outputs and
    ``start``, the weights it started from."""
    R = ref()
    m = R.dims(cell.config)
    gen = torch.Generator(dev).manual_seed(sub_seed(seed, 1))
    rp = R.init_params(gen, m)
    _, _, batches = _batches(cell, seed, dev,
                             sum(cell.traffic["check_epochs"]))
    out = R.train_steps(rp, m, _optimizer(cell), batches, fault=fault,
                        precision=precision, frozen=frozen)
    out["start"] = {k: v.cpu() for k, v in R.flat(rp).items()}
    return out


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _gaps(pairs, keep):
    """Per leaf of ``keep``, from ``pairs(k) -> (got, want)`` in float64:
    ``|‖got‖ - ‖want‖| / max(‖want‖, median ‖want‖)`` and ``‖got -
    want‖ / ‖want‖``."""
    gn, wn, err = {}, {}, []
    for k in keep:
        g, w = pairs(k)
        gn[k] = float(torch.linalg.vector_norm(g))
        wn[k] = float(torch.linalg.vector_norm(w))
        err.append(_rel(g, w))
    med = statistics.median(wn.values())
    return [abs(gn[k] - wn[k]) / max(wn[k], med, 1e-30) for k in keep], err


def numbers(got, want):
    """Every reading of the program's outputs against the reference's:

    * ``loss_gap`` / ``loss1_gap``: ``|loss - ref| / |ref|``, the worst
      checked step / the first;
    * ``head_grad_err``: the head's first gradient, ``‖prog - ref‖ /
      ‖ref‖``;
    * ``grad_gap`` / ``grad_median_gap``: the first gradient by leaf, the
      gap between the two norms of a leaf over the larger of the
      reference's norm of that leaf and of the median leaf, at the worst
      / the median leaf; ``grad_err`` / ``grad_median_err``: ``‖prog -
      ref‖ / ‖ref‖`` by leaf, worst / median;
    * ``update_gap`` / ``update_median_gap`` and ``update_err`` /
      ``update_median_err``: the parameters' change over the checked
      steps, by leaf, alike;
    * ``bias_err``: the expert biases after the checked steps, ``‖prog
      - ref‖ / ‖ref‖`` over all layers;
    * ``route_agree``: the share of the first MoE layer's token-slot
      choices at the first step that the reference made too, and
      ``route_miss``, one less it;
    * ``held_load_gap``: the program's alone, ``|held_load - 1|`` at the
      worst step it took, checked, measured and traced (0 where
      ``got`` has no steps of its own): how far the held experts' load
      strayed from expert parallelism's even share.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the leaf numbers; each leaf is compared on
    the card where there is one, one leaf at a time (both sides' outputs
    are on the host)."""
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    on = lambda t: t.to(dev, torch.float64)
    gnorm = {k: float(torch.linalg.vector_norm(on(v)))
             for k, v in want["first_grad"].items()}
    med = statistics.median(gnorm.values())
    keep = [k for k, v in gnorm.items() if v >= NEGLIGIBLE * med]
    rel = [abs(a - b) / max(abs(b), 1e-30)
           for a, b in zip(got["losses"], want["losses"])]
    if len(got["losses"]) != len(want["losses"]):
        rel = [float("inf")]
    grad_gap, grad_err = _gaps(lambda k: (on(got["first_grad"][k]),
                                          on(want["first_grad"][k])), keep)
    start = lambda k: on(want["start"][k])
    upd_gap, upd_err = _gaps(lambda k: (on(got["params"][k]) - start(k),
                                        on(want["params"][k]) - start(k)),
                             keep)
    bias = [k for k in want["params"] if k.endswith("expert_bias")]
    cat = lambda run: torch.cat([on(run["params"][k]).reshape(-1)
                                 for k in bias])
    a, b = got["choices"].to(dev), want["choices"].to(dev)
    agree = float((a[:, :, None] == b[:, None, :]).any(-1).double().mean())
    return {"loss_gap": max(rel), "loss1_gap": rel[0],
            "head_grad_err": _rel(on(got["first_grad"][HEAD]),
                                  on(want["first_grad"][HEAD])),
            "grad_gap": max(grad_gap),
            "grad_median_gap": statistics.median(grad_gap),
            "grad_err": max(grad_err),
            "grad_median_err": statistics.median(grad_err),
            "update_gap": max(upd_gap),
            "update_median_gap": statistics.median(upd_gap),
            "update_err": max(upd_err),
            "update_median_err": statistics.median(upd_err),
            "bias_err": _rel(cat(got), cat(want)) if bias else 0.0,
            "route_agree": agree, "route_miss": 1.0 - agree,
            "held_load_gap": max((abs(v - 1.0) for v in
                                  got.get("held_load", ())), default=0.0)}
