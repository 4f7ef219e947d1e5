"""The port's MoE transformers (llama4-scout-17b-a16e, llama4-maverick-
400b-a17b) against the JAX package's on the same inputs (CPU): the MoE
layer with forced drops, ties and both gates, the router loss, smoke
prefill through both attention paths, cached decode, the scheduler's
greedy tokens, one SGD train step and the SFPL loss, the launchers, the
full configs' sizes and the memory-bounded init.

Inputs are made with numpy from a seed; parameters are drawn by the JAX
package's ``init`` and carried across through ``repro_torch.convert``.
Tolerances as tests/test_torch_lm.py's: 1e-5 for a module in f32, 1e-4
for logits in f32; token ids, expert ids and the counts of dropped
tokens equal.

Decode is held against the JAX package's decode, not against the
forward: capacity is counted over the tokens of one call (B at decode),
so with drops the reference's own decode and forward differ (ROADMAP
section 3).
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.split_lm import sfpl_lm_loss as j_sfpl_lm_loss
from repro.nn import moe as JMOE
from repro.optim import sgd_momentum as j_sgd
from repro_torch.configs import get_arch
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.core.split_lm import sfpl_lm_loss
from repro_torch.launch.steps import make_train_step
from repro_torch.nn import init as TI
from repro_torch.nn import moe as TMOE
from repro_torch.optim import sgd_momentum
from repro_torch.tree import grads, tree_leaves, with_grad
from test_torch_lm import (IMPL_PAIRS, _check_batcher_greedy,
                           _check_decode_f32, _check_prefill_f32, _jnp_tree,
                           _np, _smoke)
from test_torch_lm_train import _host, _one_thread, _setup  # noqa: F401

F32 = dict(atol=1e-5, rtol=1e-5)
MOE_ARCHS = ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"]


# --------------------------------------------------------------------------
# the layer

# (name, B, S, experts, capacity factor, gate, shared expert, dp groups,
# router): "zero" routes every token to expert 0 (all logits tie)
MOE_CASES = [
    ("default", 2, 12, 4, 1.25, "sigmoid", True, 1, "normal"),
    ("forced_drops", 2, 12, 4, 0.5, "sigmoid", True, 1, "normal"),
    ("round_half_even", 1, 8, 4, 1.25, "sigmoid", True, 1, "normal"),
    ("tied_router", 2, 12, 4, 1.25, "sigmoid", True, 1, "zero"),
    ("dp_groups_2", 2, 12, 4, 1.25, "sigmoid", True, 2, "normal"),
    ("softmax_gate", 2, 12, 4, 1.25, "softmax", True, 1, "normal"),
    ("no_shared_expert", 2, 12, 4, 1.25, "sigmoid", False, 1, "normal"),
]


def _moe_inputs(B, S, E, shared, router, seed=0, d=16, f=24):
    params = _jnp_tree(JMOE.moe_init(jax.random.PRNGKey(seed), d, f, E,
                                     shared_expert=shared))
    if router == "zero":
        params["router"]["w"] = np.zeros_like(params["router"]["w"])
    else:   # logits of order 1, so that the experts differ
        params["router"]["w"] = params["router"]["w"] * 50.0
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, d)).astype(np.float32)
    return params, x


def _assert_same_drops(got, want, tokens):
    """The same number of tokens dropped. The fraction is that count over
    the tokens, whose last f32 bit the JAX package itself rounds one way
    under ``jit`` and another eagerly, so the values are held to 1e-6
    relative besides."""
    got, want = float(got), float(want)
    assert round(got * tokens) == round(want * tokens), (got, want)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_apply_matches_jax(case):
    name, B, S, E, cf, gate, shared, dp, router = case
    params, x = _moe_inputs(B, S, E, shared, router)
    kw = dict(num_experts=E, capacity_factor=cf, gate=gate, dp_groups=dp)
    jy, jaux = jax.jit(functools.partial(JMOE.moe_apply, **kw))(
        params, jnp.asarray(x))
    ty, taux = TMOE.moe_apply(from_jax_numpy(params), torch.from_numpy(x),
                              **kw)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **F32)
    np.testing.assert_allclose(_np(taux["router_logits"]),
                               np.asarray(jaux["router_logits"]), **F32)
    assert np.array_equal(taux["expert_id"].numpy(),
                          np.asarray(jaux["expert_id"]))
    _assert_same_drops(taux["dropped_frac"], jaux["dropped_frac"], B * S)
    if name in ("forced_drops", "tied_router"):
        assert float(taux["dropped_frac"]) > 0.25
    if name == "tied_router":
        assert not taux["expert_id"].any()       # the first of the ties
    if name == "round_half_even":
        # 8 / 4 * 1.25 = 2.5 rounds to 2, not 3: 8 tokens into 4 experts
        assert TMOE.capacity(8, 4, 1.25) == 2


def test_capacity_is_the_jax_formula():
    for T in (1, 2, 7, 8, 24, 1000, 16384):
        for E in (1, 4, 16, 128):
            for cf in (0.5, 1.0, 1.25, 16.0):
                assert TMOE.capacity(T, E, cf) == int(
                    max(1, round(T / E * cf)))
    assert TMOE.capacity(16384, 128, 1.25) == 160     # maverick's prefill
    assert TMOE.capacity(2, 16, 16.0) == 2            # no token dropped


def test_rank_in_sorted_groups_matches_jax():
    rng = np.random.default_rng(3)
    eid = np.sort(rng.integers(0, 5, (3, 40)), axis=-1).astype(np.int32)
    want = JMOE._rank_in_sorted_groups(jnp.asarray(eid))
    got = TMOE._rank_in_sorted_groups(torch.from_numpy(eid).long())
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gate,cf", [("sigmoid", 0.5), ("softmax", 1.25)])
def test_moe_grads_match_jax(gate, cf):
    """The gradients of ``sum(y * c) + load-balance loss`` with respect to
    every parameter and to x, with tokens dropped at capacity 0.5."""
    params, x = _moe_inputs(2, 12, 4, True, "normal", seed=4)
    c = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    kw = dict(num_experts=4, capacity_factor=cf, gate=gate)

    def jloss(p, xx):
        y, aux = JMOE.moe_apply(p, xx, **kw)
        return jnp.sum(y * c) + JMOE.router_load_balance_loss(
            aux["router_logits"], aux["expert_id"], 4)

    lj, (gpj, gxj) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        params, jnp.asarray(x))
    tp = with_grad(from_jax_numpy(params))
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = TMOE.moe_apply(tp, tx, **kw)
    lt = torch.sum(y * torch.from_numpy(c)) + TMOE.router_load_balance_loss(
        aux["router_logits"], aux["expert_id"], 4)
    np.testing.assert_allclose(lt.item(), float(lj), **F32)
    gx = torch.autograd.grad(lt, tx, retain_graph=True)[0]
    np.testing.assert_allclose(gx.numpy(), np.asarray(gxj), **F32)
    for a, b in zip(tree_leaves(to_numpy(grads(lt, tp))),
                    jax.tree_util.tree_leaves(_host(gpj))):
        np.testing.assert_allclose(a, b, **F32)


def test_router_load_balance_loss_matches_jax():
    rng = np.random.default_rng(6)
    logits = 3 * rng.standard_normal((50, 8)).astype(np.float32)
    eid = logits.argmax(-1).astype(np.int32)
    want = JMOE.router_load_balance_loss(jnp.asarray(logits),
                                         jnp.asarray(eid), 8)
    got = TMOE.router_load_balance_loss(torch.from_numpy(logits),
                                        torch.from_numpy(eid), 8)
    np.testing.assert_allclose(got.item(), float(want), **F32)


def test_moe_mesh_axes_raise():
    """``mesh_axes`` no longer raises (the sharded LM is ported): on plain
    tensors its constraints are identities, so the call equals the one
    without a mesh; a DTensor on another mesh than ``mesh_axes`` raises
    (``tests/test_torch_sharding.py`` runs the sharded layer)."""
    params, x = _moe_inputs(1, 4, 4, True, "normal")
    p, xt = from_jax_numpy(params), torch.from_numpy(x)
    got, aux = TMOE.moe_apply(p, xt, num_experts=4,
                              mesh_axes=(("data", 1), ("model", 1)))
    want, aux0 = TMOE.moe_apply(p, xt, num_experts=4)
    assert torch.equal(got, want)
    assert torch.equal(aux["expert_id"], aux0["expert_id"])


# --------------------------------------------------------------------------
# the smoke models

@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_smoke(request):
    return _smoke(request.param)


@pytest.mark.parametrize("jax_impl,port_impl", IMPL_PAIRS)
def test_moe_prefill_logits_match_jax_f32(moe_smoke, jax_impl, port_impl):
    _check_prefill_f32(moe_smoke, jax_impl, port_impl)


def test_moe_decode_logits_match_jax_f32(moe_smoke):
    """Token by token with a batch of 2: one slot an expert, so two tokens
    routed to one expert drop one (maverick's dense layers route none)."""
    _check_decode_f32(moe_smoke)


def test_moe_decode_drops_tokens_as_jax_does(moe_smoke):
    """The layer the decode step runs, on one step's (2, 1, d) input: a
    capacity of 1 drops the second of two tokens sent to one expert, in
    both packages alike."""
    jspec, params, _ = moe_smoke
    jcfg = jspec.make_smoke_config(compute_dtype="float32")
    p = next(p for p in range(jcfg.group_size) if jcfg.layer_kind(p)["moe"])
    lp = jax.tree_util.tree_map(lambda a: np.asarray(a[0], np.float32),
                                params["layers"][f"sub{p}"]["moe"])
    lp["router"]["w"] = np.zeros_like(lp["router"]["w"])  # both to expert 0
    x = np.random.default_rng(7).standard_normal(
        (2, 1, jcfg.d_model)).astype(np.float32)
    kw = dict(num_experts=jcfg.num_experts,
              capacity_factor=jcfg.capacity_factor)
    jy, jaux = JMOE.moe_apply(lp, jnp.asarray(x), **kw)
    ty, taux = TMOE.moe_apply(from_jax_numpy(lp), torch.from_numpy(x), **kw)
    assert float(taux["dropped_frac"]) == float(jaux["dropped_frac"]) == 0.5
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **F32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_differs_from_forward_as_in_jax(arch):
    """A property of the reference, not a fault of the port: capacity is
    counted over the tokens of one call, B at decode, so with drops the
    cached decode's logits differ from the forward's, in both packages
    by the same amount; at capacity factor ``num_experts`` nothing drops
    and decode equals the forward. ``pytest -s`` prints the gaps. (The
    tokens of seed 11 drop others at decode than in the forward; those
    of seed 13 happen to drop the same ones, where the two agree.)"""
    jspec = j_get_arch(arch)
    tspec = get_arch(arch)
    b, s = 2, 8
    toks = np.random.default_rng(11).integers(0, 512, (b, s)).astype(
        np.int32)
    gaps = {}
    for cf in (1.25, 4.0):
        jcfg = jspec.make_smoke_config(compute_dtype="float32",
                                       capacity_factor=cf)
        assert cf != 4.0 or jcfg.num_experts == 4
        params = _jnp_tree(jspec.model.init(jax.random.PRNGKey(0), jcfg))
        tcfg = tspec.make_smoke_config(compute_dtype="float32",
                                       capacity_factor=cf)
        tp = from_jax_numpy(params)
        jfwd, _ = jax.jit(lambda p: jspec.model.forward(
            p, {"tokens": jnp.asarray(toks)}, jcfg, training=False))(params)
        tfwd, _ = tspec.model.forward(tp, {"tokens": torch.from_numpy(toks)},
                                      tcfg)
        jstate = jspec.model.init_decode_state(jcfg, b, s, dtype=jnp.float32)
        tstate = tspec.model.init_decode_state(tcfg, b, s,
                                               dtype=torch.float32)
        jstep = jax.jit(lambda p, st, t, pos: jspec.model.decode_step(
            p, st, t, jcfg, cur_pos=pos))
        jdec, tdec = [], []
        for t in range(s):
            lg, jstate = jstep(params, jstate, jnp.asarray(toks[:, t:t + 1]),
                               jnp.int32(t))
            jdec.append(np.asarray(lg))
            lg, tstate = tspec.model.decode_step(
                tp, tstate, torch.from_numpy(toks[:, t:t + 1]), tcfg,
                cur_pos=t)
            tdec.append(_np(lg))
        gj = np.abs(np.concatenate(jdec, 1) - np.asarray(jfwd))
        gt = np.abs(np.concatenate(tdec, 1) - _np(tfwd))
        gaps[cf] = (float(gj.max()), float(gt.max()))
        np.testing.assert_allclose(gt, gj, atol=2e-4)
    print(f"{arch} decode against forward, max |diff| (JAX, port): "
          f"capacity 1.25 {gaps[1.25]}, capacity 4 (= experts) {gaps[4.0]}")
    assert min(gaps[1.25]) > 1e-2
    assert max(gaps[4.0]) < 1e-4


def test_moe_continuous_batcher_greedy_matches_jax(moe_smoke):
    _check_batcher_greedy(moe_smoke)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_matches_jax(arch):
    """One SGD step (momentum 0.9) with ``remat`` on: the loss, its
    router part (``aux``, non-zero), every gradient and the new params at
    <= 1e-5. Parameters in f32 (maverick's are bf16 in its config, where
    one rounding of a gradient to bf16 can move it a bf16 ulp)."""
    jspec, jcfg, tspec, tcfg, params, toks, labels = _setup(
        arch, remat=True, param_dtype="float32")
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    (lj, jaux), gj = jax.jit(jax.value_and_grad(
        lambda p: jspec.model.loss_fn(p, jbatch, jcfg), has_aux=True))(params)
    p = with_grad(from_jax_numpy(params))
    lt, taux = tspec.model.loss_fn(p, tbatch, tcfg)
    np.testing.assert_allclose(lt.item(), float(lj), **F32)
    np.testing.assert_allclose(taux["aux"].item(), float(jaux["aux"]), **F32)
    assert taux["aux"].item() > 0.5          # E * sum f p, about 1
    for a, b in zip(tree_leaves(to_numpy(grads(lt, p))),
                    jax.tree_util.tree_leaves(_host(gj))):
        np.testing.assert_allclose(a, b, **F32)
    # the step: the JAX optimizer on JAX's gradients, the port's whole
    # make_train_step on its own
    jopt, topt = j_sgd(1e-2, momentum=0.9), sgd_momentum(1e-2, momentum=0.9)
    jp, _ = jopt.update(gj, jopt.init(params), params, 0)
    tp0 = from_jax_numpy(params)
    tp, _, step, tl = make_train_step(tspec, tcfg, topt)(
        tp0, topt.init(tp0), 0, tbatch)
    assert step == 1
    np.testing.assert_allclose(float(tl), float(lj), **F32)
    for a, b in zip(tree_leaves(to_numpy(tp)),
                    jax.tree_util.tree_leaves(_host(jp))):
        np.testing.assert_allclose(a, b, **F32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_sfpl_lm_loss_matches_jax(arch):
    """``sfpl_lm_loss`` at 4 layers (2 groups, cut after the first) with a
    non-identity JAX permutation: the loss, its router part and every
    gradient at <= 1e-5."""
    jspec, jcfg, tspec, tcfg, params, toks, labels = _setup(
        arch, num_layers=4, param_dtype="float32")
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(5), 4))
    assert not np.array_equal(perm, np.arange(4))
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (lj, jaux), gj = jax.jit(jax.value_and_grad(
        lambda p: j_sfpl_lm_loss(jspec.model, p, jbatch, jcfg,
                                 perm=jnp.asarray(perm)),
        has_aux=True))(params)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    p = with_grad(from_jax_numpy(params))
    lt, taux = sfpl_lm_loss(tspec.model, p, tbatch, tcfg,
                            perm=torch.from_numpy(np.array(perm)))
    np.testing.assert_allclose(lt.item(), float(lj), **F32)
    np.testing.assert_allclose(taux["aux"].item(), float(jaux["aux"]), **F32)
    assert taux["aux"].item() > 0.5
    for a, b in zip(tree_leaves(to_numpy(grads(lt, p))),
                    jax.tree_util.tree_leaves(_host(gj))):
        np.testing.assert_allclose(a, b, **F32)


# --------------------------------------------------------------------------
# the launchers, the full configs, init and conversion

def test_train_lm_and_evaluate_lm_run_scout(tmp_path, capsys):
    """``launch.train --arch llama4-scout-17b-a16e`` (smoke, CPU) trains,
    checkpoints, and ``launch.eval`` restores and evaluates it."""
    from repro_torch.launch.eval import main as eval_main
    from repro_torch.launch.train import main as train_main
    ckpt = str(tmp_path / "scout.npz")
    train_main(["--arch", "llama4-scout-17b-a16e", "--steps", "6", "--seq",
                "16", "--batch", "4", "--ckpt", ckpt, "--device", "cpu"])
    out = capsys.readouterr().out
    first, last = (float(x) for x in
                   out.split("first loss ")[1].split(" -> last loss "))
    assert math.isfinite(first) and last < first, out
    eval_main(["--arch", "llama4-scout-17b-a16e", "--ckpt", ckpt,
               "--batches", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored step 6" in out
    assert math.isfinite(float(
        out.split("llama4-scout-17b-a16e: loss ")[1].split()[0]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_runs_moe_archs(arch):
    from repro_torch.launch.serve import serve
    out = serve(arch, batch=2, prompt_len=4, gen=3, device="cpu")
    assert tuple(out.shape) == (2, 3)
    assert 0 <= int(out.min()) and int(out.max()) < 512


def _meta_count(arch):
    """Parameters of ``arch``'s full config, counted on the meta device
    (no storage is allocated)."""
    spec = get_arch(arch)
    with torch.device("meta"):
        params = spec.model.init(None, spec.make_config())
    assert all(t.is_meta for t in tree_leaves(params))
    return sum(t.numel() for t in tree_leaves(params)), params


@pytest.mark.parametrize("arch,params_b", [
    ("llama4-scout-17b-a16e", 107.8), ("llama4-maverick-400b-a17b", 400.7)])
def test_full_config_param_counts(arch, params_b):
    """The model cards' sizes (tests/test_arch_smoke.py's), and the same
    count and leaf shapes as the JAX package's ``init``."""
    n, params = _meta_count(arch)
    assert abs(n / 1e9 - params_b) / params_b < 0.03, n / 1e9
    jspec = j_get_arch(arch)
    shapes = jax.eval_shape(lambda: jspec.model.init(jax.random.PRNGKey(0),
                                                     jspec.make_config()))
    assert [tuple(t.shape) for t in tree_leaves(params)] == [
        tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)]


def test_small_leaves_draw_as_before_large_ones_in_slices(monkeypatch):
    """A leaf of at most ``SLICED_DRAW`` elements draws exactly the
    numbers of one ``randn`` call, as before the sliced draw existed;
    above it the leaf is drawn slice by slice into the target dtype:
    every element written, the standard deviation kept, deterministic
    for a seed."""
    gen = torch.Generator().manual_seed(0)
    got = TI.lecun_normal(gen, (64, 48), dtype=torch.bfloat16)
    ref = (torch.randn((64, 48), generator=torch.Generator().manual_seed(0))
           * math.sqrt(1 / 64)).to(torch.bfloat16)
    assert torch.equal(got, ref)
    monkeypatch.setattr(TI, "SLICED_DRAW", 1000)
    monkeypatch.setattr(TI, "_SLICE", 384)
    a = TI.normal_init(torch.Generator().manual_seed(1), (3, 50, 20),
                       stddev=0.5, dtype=torch.bfloat16)
    b = TI.normal_init(torch.Generator().manual_seed(1), (3, 50, 20),
                       stddev=0.5, dtype=torch.bfloat16)
    assert a.dtype == torch.bfloat16 and a.shape == (3, 50, 20)
    assert torch.equal(a, b)
    assert bool((a != 0).all())          # no slot left unwritten
    assert abs(float(a.float().std()) - 0.5) < 0.05


def test_one_group_init_is_its_group_without_a_copy():
    """A model of one layer group keeps the group's own tensors as its
    stacked leaves (views with a leading axis of 1): the same numbers as a
    draw of the group, and no second copy."""
    from repro_torch.models import transformer as T
    spec = get_arch("llama4-scout-17b-a16e")
    cfg = spec.make_smoke_config()
    assert cfg.num_layers // cfg.group_size == 1
    params = T.init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(0)
    T.embedding_init(gen, cfg.vocab_size, cfg.d_model)
    T.rmsnorm_init(gen, cfg.d_model)
    T.dense_init(gen, cfg.d_model, cfg.vocab_size, use_bias=False)
    group = {f"sub{p}": T._layer_init(gen, cfg, cfg.layer_kind(p))
             for p in range(cfg.group_size)}
    for a, b in zip(tree_leaves(params["layers"]), tree_leaves(group)):
        assert a.shape == (1,) + b.shape and torch.equal(a[0], b)
        assert a._base is not None           # a view of the drawn leaf


def test_moe_tree_round_trips_bitwise_with_jax_structure():
    """maverick's smoke tree, bf16 leaves included: the expert stacks
    ``wi`` / ``wg`` / ``wo`` (4 dims, not named ``w``) keep their layout,
    and the round trip is bit for bit."""
    jspec = j_get_arch("llama4-maverick-400b-a17b")
    params = _jnp_tree(jspec.model.init(jax.random.PRNGKey(0),
                                        jspec.make_smoke_config()))
    moe = params["layers"]["sub1"]["moe"]
    assert moe["wi"].ndim == 4 and moe["wi"].dtype.name == "bfloat16"
    tp = from_jax_numpy(params)
    assert tp["layers"]["sub1"]["moe"]["wi"].dtype == torch.bfloat16
    assert tuple(tp["layers"]["sub1"]["moe"]["wi"].shape) == moe["wi"].shape
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(tp)),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    port = tree_leaves(get_arch("llama4-maverick-400b-a17b").model.init(
        torch.Generator().manual_seed(0),
        get_arch("llama4-maverick-400b-a17b").make_smoke_config()))
    assert [(tuple(t.shape), t.dtype) for t in port] == [
        (tuple(t.shape), t.dtype) for t in tree_leaves(tp)]
