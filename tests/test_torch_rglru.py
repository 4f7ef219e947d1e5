"""The port's RG-LRU hybrid (recurrentgemma-9b) against the JAX package's
on the same inputs (CPU): the RG-LRU cell and its scan, the recurrent
block, the smoke model's prefill on both attention paths, cached decode
through the local-attention ring, one SGD train step, the launchers, the
full config's size, and the parameter tree's round trip.

Inputs are made with numpy from a seed; parameters are drawn by the JAX
package's ``init`` and carried across through ``repro_torch.convert``.
Tolerances are those of tests/test_torch_lm.py and
tests/test_torch_lm_train.py: modules, losses, gradients and params 1e-5
in f32, model logits 1e-4 in f32.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch.steps import (make_decode_step as j_decode_step,
                                make_prefill_step as j_prefill_step)
from repro.models import rglru as JG
from repro.optim import sgd_momentum as j_sgd
from repro_torch.configs import get_arch
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import rglru as TG
from repro_torch.optim import sgd_momentum
from repro_torch.tree import grads, tree_leaves, with_grad
from test_torch_lm import (F32, IMPL_PAIRS, LOGITS_F32, _jnp_tree, _normal,
                           _np)
from test_torch_lm_train import _host, _one_thread  # noqa: F401

ARCH = "recurrentgemma-9b"


def _cfgs(jax_impl="xla", port_impl="xla", **kw):
    """The JAX smoke config in f32 (``kw`` overrides) and the port's with
    the same fields, on ``port_impl``'s attention path."""
    jcfg = dataclasses.replace(j_get_arch(ARCH).make_smoke_config(
        compute_dtype="float32", attention_impl=jax_impl), **kw)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(TG.RGLRUConfig)}
    fields["attention_impl"] = port_impl
    return jcfg, TG.RGLRUConfig(**fields)


@pytest.fixture(scope="module")
def smoke():
    """The smoke model (5 layers: one group and 2 trailing rec blocks, d
    128, window 8), params drawn by JAX, and tokens (2, 40): past the
    window, so it binds."""
    jcfg, _ = _cfgs()
    params = _jnp_tree(JG.init(jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size,
                                              (2, 40)).astype(np.int32)
    return params, toks


# --------------------------------------------------------------------------
# the RG-LRU cell and the recurrent block

def _lru(width=16, seed=0):
    return _jnp_tree(JG.rglru_init(jax.random.PRNGKey(seed), width,
                                   jnp.float32))


@pytest.mark.parametrize("seq", [1, 2, 7, 64, 257])
def test_rglru_apply_matches_jax_and_its_steps(seq):
    """The associative scan at odd and even lengths (257 recurses through
    odd and even halves) against the JAX package's ``rglru_apply``, and
    against a chain of the port's own ``rglru_step``."""
    p = _lru()
    x = _normal(np.random.default_rng(seq), 2, seq, 16)
    want = jax.jit(JG.rglru_apply)(p, jnp.asarray(x))
    tp = from_jax_numpy(p)
    got = TG.rglru_apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    h = torch.zeros((2, 16))
    steps = []
    for t in range(seq):
        y, h = TG.rglru_step(tp, torch.from_numpy(x[:, t]), h)
        steps.append(y)
    np.testing.assert_allclose(_np(torch.stack(steps, dim=1)), _np(got),
                               **F32)


def test_associative_scan_is_the_linear_recurrence():
    """``h_t = a_t h_{t-1} + b_t`` and the running product of ``a``, in
    f64 so that the order of the combines does not show."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (3, 45, 5)))
    b = torch.from_numpy(rng.standard_normal((3, 45, 5)))
    prod, h = TG.associative_scan(a, b)
    hs, run = torch.zeros((3, 5), dtype=torch.float64), []
    for t in range(45):
        hs = a[:, t] * hs + b[:, t]
        run.append(hs)
    torch.testing.assert_close(h, torch.stack(run, dim=1), rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(prod, torch.cumprod(a, dim=1), rtol=1e-12,
                               atol=1e-12)


def test_rglru_gates_follow_jax_at_extreme_lambda():
    """softplus is ``logaddexp(lam, 0)`` with no threshold, and ``1 - a^2``
    stays floored at 1e-12: lambda of -30 and 40 give JAX's gates."""
    p = _lru(width=4)
    p["lambda"] = np.array([-30.0, -1.0, 5.0, 40.0], np.float32)
    x = _normal(np.random.default_rng(4), 2, 3, 4)
    ja, jb = JG._rglru_gates(p, jnp.asarray(x), 8.0)
    ta, tb = TG._rglru_gates(from_jax_numpy(p), torch.from_numpy(x), 8.0)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), **F32)
    np.testing.assert_allclose(_np(tb), np.asarray(jb), **F32)


def test_rec_block_apply_matches_jax():
    jcfg, tcfg = _cfgs()
    p = _jnp_tree(JG.rec_block_init(jax.random.PRNGKey(5), jcfg))
    x = _normal(np.random.default_rng(6), 2, 19, jcfg.d_model)
    want = jax.jit(lambda p_, x_: JG.rec_block_apply(p_, x_, jcfg))(
        p, jnp.asarray(x))
    got = TG.rec_block_apply(from_jax_numpy(p), torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


# --------------------------------------------------------------------------
# the smoke model

@pytest.mark.parametrize("jax_impl,port_impl", IMPL_PAIRS)
def test_rglru_prefill_logits_match_jax_f32(smoke, jax_impl, port_impl):
    """Every position's logits (the prefill step's last one too) at S 40,
    five times the window: the xla path against JAX's, the kernel path
    (K7's plain version on the CPU) against JAX's xla and Pallas paths."""
    params, toks = smoke
    jcfg, tcfg = _cfgs(jax_impl, port_impl)
    jspec, tspec = j_get_arch(ARCH), get_arch(ARCH)
    want, _ = jax.jit(lambda p, t: JG.forward(p, {"tokens": t}, jcfg,
                                              training=False))(
        params, jnp.asarray(toks))
    tp = from_jax_numpy(params)
    got, _ = TG.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert tuple(got.shape) == want.shape == (2, 40, jcfg.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGITS_F32)
    last = make_prefill_step(tspec, tcfg)(tp,
                                          {"tokens": torch.from_numpy(toks)})
    jlast = jax.jit(j_prefill_step(jspec, jcfg))(
        params, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(_np(last), np.asarray(jlast), **LOGITS_F32)


def test_rglru_decode_logits_match_jax_f32(smoke):
    """Token by token through the recurrent states and the 8-slot ring
    cache (20 tokens: the ring wraps twice) against JAX's decode, and the
    port's decode against its own forward."""
    params, toks = smoke
    toks = toks[:, :20]
    jcfg, tcfg = _cfgs()
    jspec, tspec = j_get_arch(ARCH), get_arch(ARCH)
    jstate = JG.init_decode_state(jcfg, 2, 20, dtype=jnp.float32)
    tstate = TG.init_decode_state(tcfg, 2, 20, dtype=torch.float32)
    assert tstate["groups"]["sub2"]["k"].shape == (1, 2, 8, 1, 64)
    jstep = jax.jit(j_decode_step(jspec, jcfg))
    tstep = make_decode_step(tspec, tcfg)
    tp = from_jax_numpy(params)
    dec = []
    for t in range(toks.shape[1]):
        want, jstate = jstep(params, jstate, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        got, tstate = tstep(tp, tstate, torch.from_numpy(toks[:, t:t + 1]),
                            t)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGITS_F32)
        dec.append(got)
    fwd, _ = TG.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(_np(torch.cat(dec, dim=1)), _np(fwd),
                               **LOGITS_F32)


def test_rglru_decode_state_groups_are_not_aliased():
    """The stacked states are copies, not views of one group's: the port
    writes them in place, so a broadcast view would write every group."""
    _, tcfg = _cfgs(num_layers=6)
    state = TG.init_decode_state(tcfg, 2, 16, dtype=torch.float32)
    assert tcfg.num_groups == 2
    for sub in state["groups"].values():
        for a in sub.values():
            a[0].fill_(1)
            assert bool((a[1] != 1).all())


def test_rglru_train_step_matches_jax():
    """One SGD step (momentum 0.9), the port's with ``remat`` on (a memory
    policy that changes no value; JAX's reference without it, which
    compiles faster): the loss, every gradient and the new params at <=
    1e-5."""
    jcfg, _ = _cfgs()
    _, tcfg = _cfgs(remat=True)
    params = _host(JG.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels)}
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: JG.loss_fn(p, jbatch, jcfg), has_aux=True))(params)
    p = with_grad(from_jax_numpy(params))
    lt, _ = TG.loss_fn(p, tbatch, tcfg)
    np.testing.assert_allclose(lt.item(), float(lj), **F32)
    for a, b in zip(tree_leaves(to_numpy(grads(lt, p))),
                    jax.tree_util.tree_leaves(_host(gj))):
        np.testing.assert_allclose(a, b, **F32)
    jopt, topt = j_sgd(1e-2, momentum=0.9), sgd_momentum(1e-2, momentum=0.9)
    jp, _ = jopt.update(gj, jopt.init(params), params, 0)
    tp0 = from_jax_numpy(params)
    tp, _, step, tl = make_train_step(get_arch(ARCH), tcfg, topt, sfpl=True)(
        tp0, topt.init(tp0), 0, dict(tbatch, perm=torch.arange(4)))
    assert step == 1
    np.testing.assert_allclose(float(tl), float(lj), **F32)
    for a, b in zip(tree_leaves(to_numpy(tp)),
                    jax.tree_util.tree_leaves(_host(jp))):
        np.testing.assert_allclose(a, b, **F32)


# --------------------------------------------------------------------------
# the launchers, the full config and conversion

def test_train_lm_and_evaluate_lm_run_rglru(tmp_path, capsys):
    """``launch.train --arch recurrentgemma-9b`` (smoke, CPU) trains to
    finite losses and checkpoints; ``launch.eval`` restores the
    checkpoint, whose loss differs from the untrained init's. (Six steps
    of the Markov stream move the loss by noise in both packages, so no
    fall is asserted here; the train step is held against JAX above.)"""
    _check_train_eval(ARCH, tmp_path, capsys)


def _check_train_eval(arch, tmp_path, capsys):
    from repro_torch.launch.eval import main as eval_main
    from repro_torch.launch.train import main as train_main
    ckpt = str(tmp_path / "lm.npz")
    train_main(["--arch", arch, "--steps", "6", "--seq", "16", "--batch",
                "4", "--ckpt", ckpt, "--device", "cpu"])
    out = capsys.readouterr().out
    losses = [float(x) for x in
              out.split("first loss ")[1].split(" -> last loss ")]
    assert all(math.isfinite(x) for x in losses), out
    evals = []
    for extra in ([], ["--ckpt", ckpt]):
        eval_main(["--arch", arch, "--batches", "1", "--seq", "16",
                   "--device", "cpu"] + extra)
        out = capsys.readouterr().out
        evals.append(float(out.split(f"{arch}: loss ")[1].split()[0]))
    assert "restored step 6" in out
    assert all(math.isfinite(x) for x in evals) and evals[0] != evals[1]


def test_serve_runs_rglru():
    from repro_torch.launch.serve import serve
    out = serve(ARCH, batch=2, prompt_len=6, gen=5, device="cpu")
    assert tuple(out.shape) == (2, 5)
    assert 0 <= int(out.min()) and int(out.max()) < 512


def test_full_config_param_count():
    """recurrentgemma-9b's 9.40 B parameters (tests/test_arch_smoke.py's
    model card), counted on the meta device, with the JAX package's leaf
    shapes."""
    spec = get_arch(ARCH)
    with torch.device("meta"):
        params = spec.model.init(None, spec.make_config())
    leaves = tree_leaves(params)
    assert all(t.is_meta for t in leaves)
    n = sum(t.numel() for t in leaves)
    assert abs(n / 1e9 - 9.40) / 9.40 < 0.01, n
    jspec = j_get_arch(ARCH)
    shapes = jax.eval_shape(lambda: jspec.model.init(jax.random.PRNGKey(0),
                                                     jspec.make_config()))
    assert [tuple(t.shape) for t in leaves] == [
        tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)]


def test_rglru_tree_round_trips_with_jax_structure(smoke):
    """The conv weights ``(groups, 4, W)`` keep their layout (fewer than 4
    dims: no ResNet conv), ``lru.lambda`` carries across, the round trip
    is bit for bit, and the port's own init has the same leaves."""
    params, _ = smoke
    tp = from_jax_numpy(params)
    conv = params["layers"]["sub0"]["mix"]["conv"]["w"]
    assert conv.ndim == 3
    assert tuple(tp["layers"]["sub0"]["mix"]["conv"]["w"].shape) == \
        conv.shape
    assert tuple(tp["trailing"]["sub1"]["mix"]["lru"]["lambda"].shape) == \
        (128,)
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(tp)),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    _, tcfg = _cfgs()
    port = tree_leaves(TG.init(torch.Generator().manual_seed(0), tcfg))
    assert [(tuple(t.shape), t.dtype) for t in port] == [
        (tuple(t.shape), t.dtype) for t in tree_leaves(tp)]
