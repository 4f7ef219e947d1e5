"""The port's afmoe architecture (``trinity-mini``) against the plain
reference ``bench/programs/split_lm_ref.py`` on the CPU, at the smoke
config in float32, on the reference's seeded weights: one SFPL step
through ``make_train_step`` (loss, every gradient leaf, the AdamW step and
the expert bias's step), single layers of each kind, the expert-parallel
share of a MoE layer, the MoE counters, and the cut's shuffle through the
collector's K1 path.

The JAX package has no afmoe, so the reference is the plain version.
Tolerances: 1e-5 between two float32 computations of the same sums in
other orders (the port's f32 bound, ``tests/test_torch_lm_train.py``);
AdamW at eps 1e-4, as the cross-package step tests take it, since at
1e-8 it turns the gradients' round-off into whole steps.
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch import trace as T
from repro_torch.configs import get_arch, list_archs
from repro_torch.core.split_lm import sfpl_lm_loss
from repro_torch.launch.steps import make_train_step, trainable
from repro_torch.models import transformer as TM
from repro_torch.models.common import expand_perm, take_rows
from repro_torch.nn.moe import (moe_dropless_apply, moe_dropless_init,
                                record_routing)
from repro_torch.optim import adamw
from repro_torch.tree import grads as tree_grads, tree_map, with_grad

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "split_lm_ref_tests", ROOT / "bench" / "programs" / "split_lm_ref.py")
R = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)

F32 = dict(rtol=1e-5, atol=1e-5)
OPT = {"lr": 3e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-4, "weight_decay": 0.1}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    return get_arch("trinity-mini").make_smoke_config(
        compute_dtype="float32", **kw)


def _dims(cfg):
    held = cfg.experts_held or (0, cfg.num_experts)
    return {"d": cfg.d_model, "heads": cfg.num_heads,
            "kv": cfg.num_kv_heads, "hd": cfg.head_dim,
            "layers": cfg.num_layers, "dense": cfg.num_dense_layers,
            "ff_dense": cfg.d_ff_dense, "ff": cfg.d_ff,
            "experts": cfg.num_experts, "held": held,
            "top_k": cfg.moe_top_k, "shared": 1,
            "route_norm": True, "route_scale": cfg.route_scale,
            "window": cfg.sliding_window, "period": cfg.global_attn_period,
            "theta": cfg.rope_theta, "eps": cfg.norm_eps,
            "vocab": cfg.vocab_size, "bias_rate": cfg.expert_bias_rate,
            "embed_scale": cfg.embed_scale}


def _stack(layers):
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def _to_port(rp, cfg):
    nd = cfg.num_dense_layers
    out = {k: rp[k] for k in ("embed", "unembed", "final_norm")}
    out["dense_layers"] = {"sub0": _stack(rp["layers"][:nd])}
    out["layers"] = {"sub0": _stack(rp["layers"][nd:])}
    return out


def _by_layer(tree, cfg):
    """The port's tree by the reference's ``flat`` names."""
    out = {}
    for k in ("embed", "unembed", "final_norm"):
        out.update({f"{k}.{n}": v for n, v in R.flat(tree[k]).items()})
    for stack, first in (("dense_layers", 0),
                         ("layers", cfg.num_dense_layers)):
        for n, v in R.flat(tree[stack]["sub0"]).items():
            for g in range(v.shape[0]):
                out[f"layers.{first + g}.{n}"] = v[g]
    return out


def _data(cfg, seed, clients=4, seq=12):
    gen = torch.Generator().manual_seed(seed)
    m = _dims(cfg)
    rp = R.init_params(gen, m)
    # the routing a little off zero, so that the top-k has no ties
    for lp in rp["layers"][cfg.num_dense_layers:]:
        lp["moe"]["expert_bias"] = torch.randn(
            cfg.num_experts, generator=gen) * 0.1
    tokens, labels = R.make_batch(gen, clients, seq, cfg.vocab_size)
    return m, rp, (tokens, labels, R.make_perm(gen, clients))


def test_trinity_is_the_ports_own_arch():
    assert "trinity-mini" not in list_archs()
    spec = get_arch("trinity-mini")
    assert spec.arch_id == "trinity-mini" and spec.family == "transformer"
    cfg = spec.make_config()
    assert (cfg.num_layers, cfg.d_model, cfg.num_experts, cfg.moe_top_k,
            cfg.d_ff, cfg.d_ff_dense, cfg.vocab_size) == (
        32, 2048, 128, 8, 1024, 6144, 200192)
    kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
    assert [k["moe"] for k in kinds] == [False, False] + [True] * 30
    assert [i for i, k in enumerate(kinds) if k["window"] is None] == \
        list(range(3, 32, 4))


def test_sfpl_loss_and_every_gradient_leaf_match_the_reference():
    cfg = _cfg(remat=True)
    m, rp, (tokens, labels, perm) = _data(cfg, 1)
    p = with_grad(_to_port(rp, cfg))
    loss, _ = sfpl_lm_loss(TM, p, {"tokens": tokens, "labels": labels},
                           cfg, perm=perm, cut_groups=cfg.num_dense_layers)
    got = _by_layer(tree_grads(loss, p), cfg)
    leaves = R.flat(rp)
    train = {k: v.clone().requires_grad_() for k, v in leaves.items()
             if not R.is_buffer(k)}
    want_loss = R.Model(m).loss(R._unflat({**leaves, **train}, rp), tokens,
                                labels, perm)
    want = dict(zip(train, torch.autograd.grad(want_loss,
                                               list(train.values()))))
    torch.testing.assert_close(loss, want_loss, **F32)
    assert set(want) <= set(got)
    for k in want:
        torch.testing.assert_close(got[k], want[k], **F32, msg=k)


def test_one_train_step_matches_the_reference_adamw_and_bias_step():
    """``make_train_step(sfpl=True)`` under remat: the loss, the params
    after AdamW, and each MoE layer's expert bias stepped once by the
    forward's counts (not again by the recompute)."""
    cfg = _cfg(remat=True)
    m, rp, batch = _data(cfg, 2)
    tokens, labels, perm = batch
    spec = get_arch("trinity-mini")
    opt = adamw(OPT["lr"], b1=OPT["b1"], b2=OPT["b2"], eps=OPT["eps"],
                weight_decay=OPT["weight_decay"])
    params = _to_port(rp, cfg)
    state = opt.init(trainable(params))
    step = make_train_step(spec, cfg, opt, sfpl=True)
    new, _, k, loss = step(params, state, 0, {"tokens": tokens,
                                              "labels": labels,
                                              "perm": perm})
    want = R.train_steps(rp, m, OPT, [batch])
    assert k == 1
    torch.testing.assert_close(float(loss), want["losses"][0], **F32)
    got = _by_layer(new, cfg)
    assert set(got) == set(want["params"])
    for name, v in want["params"].items():
        torch.testing.assert_close(got[name], v, **F32, msg=name)
    bias = [n for n in got if R.is_buffer(n)]
    assert len(bias) == cfg.num_layers - cfg.num_dense_layers
    for n in bias:
        step_size = (got[n] - R.flat(rp)[n]).abs()
        assert torch.all(((step_size - cfg.expert_bias_rate).abs() < 1e-7)
                         | (step_size == 0)), n


@pytest.mark.parametrize("ffn", ["dense", "moe"])
@pytest.mark.parametrize("layer", [0, 3], ids=["window", "full"])
def test_each_layer_kind_matches_the_reference(ffn, layer):
    """A dense and a MoE layer, each as a windowed layer with RoPE (index
    0) and as a full layer without (index 3), at S 12 past the window
    of 4."""
    cfg = _cfg()
    m, rp, _ = _data(cfg, 3)
    lp = rp["layers"][0 if ffn == "dense" else cfg.num_dense_layers]
    x = torch.randn(2, 12, cfg.d_model, generator=torch.Generator()
                    .manual_seed(4))
    kind = {"moe": ffn == "moe",
            "window": None if (layer + 1) % 4 == 0 else cfg.sliding_window}
    pos = torch.arange(12).expand(2, 12)
    got, _ = TM._layer_apply(lp, x, cfg, kind, pos, training=False)
    want = R.Model(m).layer(lp, x, layer)
    torch.testing.assert_close(got, want, **F32)


def test_the_shares_of_eight_devices_add_up_to_the_whole_layer():
    """16 experts over 8 devices, 2 held each: the held experts' parts of
    the 8 shares, with the shared expert counted once, add up to the layer
    with every expert held (and to the reference's whole layer)."""
    gen = torch.Generator().manual_seed(5)
    E, d, f = 16, 32, 16
    whole = moe_dropless_init(gen, d, f, E)
    whole["expert_bias"] = torch.randn(E, generator=gen) * 0.1
    x = torch.randn(3, 10, d, generator=gen)
    kw = dict(num_experts=E, top_k=4, route_scale=2.826)
    y_whole, _ = moe_dropless_apply(whole, x, **kw)
    total = torch.zeros_like(x)
    for s in range(8):
        lo = 2 * s
        part = {k: whole[k] for k in ("router", "expert_bias")}
        part.update({k: whole[k][lo:lo + 2] for k in ("wi", "wg", "wo")})
        if s == 0:
            part["shared"] = whole["shared"]
        total = total + moe_dropless_apply(part, x, held=(lo, 2), **kw)[0]
    torch.testing.assert_close(total, y_whole, **F32)
    m = {"experts": E, "held": (0, E), "top_k": 4, "route_norm": True,
         "route_scale": 2.826}
    want = R.Model(m).moe(whole, x)
    torch.testing.assert_close(y_whole, want, **F32)


def test_a_layer_without_router_gradient_matches_the_reference():
    """Experts 2-4 of 8 held: the output and the held and shared experts'
    gradients against the reference's layer, and no gradient for the
    router, which would need the other experts' outputs."""
    gen = torch.Generator().manual_seed(8)
    E, d, f, held = 8, 32, 16, (2, 3)
    p = moe_dropless_init(gen, d, f, E, held=held)
    p["expert_bias"] = torch.randn(E, generator=gen) * 0.1
    x = torch.randn(2, 9, d, generator=gen)
    g = torch.randn(2, 9, d, generator=gen)
    kw = dict(num_experts=E, top_k=4, held=held, route_scale=2.826)
    got_p = with_grad(p)
    y, _ = moe_dropless_apply(got_p, x, **kw)
    got = R.flat(tree_grads((y * g).sum(), got_p))
    m = {"experts": E, "held": held, "top_k": 4, "route_norm": True,
         "route_scale": 2.826}
    want_p = with_grad(p)
    want_y = R.Model(m).moe(want_p, x)
    want = R.flat(tree_grads((want_y * g).sum(), want_p))
    torch.testing.assert_close(y, want_y, **F32)
    for k in want:
        torch.testing.assert_close(got[k], want[k], **F32, msg=k)
    assert not got["router.w"].any()
    assert got["shared.wi.w"].abs().max() > 0 and got["wo"].abs().max() > 0


def test_moe_counters_and_routing_record_match_closed_forms():
    """Per call: ``tokens`` is B * S; ``held_rows`` the token-slots routed
    to the held range (at most top_k a token); a ``record_routing`` sees
    each call's counts, which sum to B * S * top_k."""
    gen = torch.Generator().manual_seed(6)
    E, k, held = 8, 2, (3, 4)
    p = moe_dropless_init(gen, 16, 8, E, held=held)
    x = torch.randn(2, 5, 16, generator=gen)
    T.reset()
    with record_routing(keep_choices=True) as rec:
        for _ in range(3):
            moe_dropless_apply(p, x, num_experts=E, top_k=k, held=held)
    idx = rec.choices[0]
    c = torch.bincount(idx.reshape(-1), minlength=E)
    inside = c[held[0]:held[0] + held[1]]
    assert T.COUNTERS["moe"] == {"calls": 3, "tokens": 3 * 10,
                                 "held_rows": 3 * int(inside.sum())}
    assert len(rec.counts) == 3 and int(rec.counts[0].sum()) == 10 * k
    assert torch.equal(rec.counts[0], c)
    T.reset()


def test_the_cuts_shuffle_through_the_collector_path_is_index_select():
    """``take_rows``' K1 path (on the CPU its plain version) permutes the
    (B * S, d) token rows by the sequence permutation expanded to them:
    bit-equal to ``index_select`` of whole sequences, counted in
    ``permuted_bytes``; labels keep their gather."""
    from repro_torch.models.common import _k1_take_rows
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(5, 6, 8, generator=gen).to(torch.bfloat16)
    perm = torch.randperm(5, generator=gen)
    before = T.COUNTERS["sfpl"]["permuted_bytes"]
    got = _k1_take_rows(x, perm)
    assert torch.equal(got, x.index_select(0, perm))
    assert T.COUNTERS["sfpl"]["permuted_bytes"] - before == x.numel() * 2
    assert torch.equal(expand_perm(perm, 6).reshape(5, 6),
                       perm[:, None] * 6 + torch.arange(6))
    labels = torch.randint(0, 9, (5, 6), generator=gen)
    assert torch.equal(take_rows(labels, perm), labels[perm])
