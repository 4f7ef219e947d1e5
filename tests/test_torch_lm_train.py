"""The port's LM training path against the JAX package's on the same
inputs (CPU), at the smoke configs in f32: the chunked loss, AdamW, one
train step of the transformer and the xLSTM, the SFPL cut-layer shuffle,
the token stream, and train -> checkpoint -> eval.

Parameters are drawn by the JAX package's ``init`` and carried across
through ``repro_torch.convert``; batches and permutations are drawn in JAX
(``jax.random`` cannot be reproduced in torch) or with numpy from a seed.
Tolerances: 1e-6 between the chunked and the plain loss of one package
(tests/test_models_consistency.py), 1e-5 between the packages (the
reference's f32 bound, tests/test_submesh.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core.split_lm import sfpl_lm_loss as j_sfpl_lm_loss
from repro.data.tokens import synthetic_token_stream as j_stream
from repro.launch.steps import make_train_step as j_make_train_step
from repro.optim import adamw as j_adamw
from repro_torch.configs import get_arch
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.core.split_lm import make_collector_perm, sfpl_lm_loss
from repro_torch.data.tokens import synthetic_token_stream
from repro_torch.launch.steps import make_train_step
from repro_torch.models.common import (IGNORE_LABEL, chunked_lm_loss,
                                       softmax_cross_entropy)
from repro_torch.optim import adamw
from repro_torch.tree import grads, tree_leaves, with_grad

F32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these small tensors: the suite runs several
    workers at once, and with more threads than cores each small op waits
    on the others' threads (measured: 5 s alone, up to 284 s under the
    suite's load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_cfg(arch, jcfg):
    """The port's config with the JAX config's value for every field the
    port has (the xLSTM's lacks the JAX memory policies)."""
    tspec = get_arch(arch)
    cls = type(tspec.make_smoke_config())
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)}
    return tspec, cls(**fields)


def _setup(arch, batch=4, seq=16, **kw):
    jspec = j_get_arch(arch)
    jcfg = dataclasses.replace(
        jspec.make_smoke_config(compute_dtype="float32"), **kw)
    params = _host(jspec.model.init(jax.random.PRNGKey(0), jcfg))
    toks, labels = j_stream(jax.random.PRNGKey(1), batch=batch,
                            seq_len=seq, vocab=jcfg.vocab_size)
    tspec, tcfg = _port_cfg(arch, jcfg)
    return jspec, jcfg, tspec, tcfg, params, np.asarray(toks), \
        np.asarray(labels)


# --------------------------------------------------------------------------
# the loss


def test_chunked_lm_loss_matches_plain():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 12, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 31)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 31, (2, 12)))
    labels[0, 3] = IGNORE_LABEL
    unembed = lambda xc: xc @ w
    plain = softmax_cross_entropy(unembed(x), labels)
    for chunks in (1, 2, 3, 4, 5, 6, 8):   # 5 and 8 reduce to 4 and 6
        chunked = chunked_lm_loss(x, labels, unembed, chunks=chunks)
        np.testing.assert_allclose(float(chunked), float(plain), rtol=1e-6)


def test_chunked_lm_loss_grads_match_jax():
    """Value and gradients of the chunked loss (recomputed in the
    backward, one chunk's logits at a time) against JAX's."""
    from repro.models.common import chunked_lm_loss as j_chunked
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 12, 16)).astype(np.float32)
    w = rng.standard_normal((16, 31)).astype(np.float32)
    labels = rng.integers(0, 31, (2, 12)).astype(np.int32)
    labels[1, 5] = IGNORE_LABEL
    lj, (gxj, gwj) = jax.value_and_grad(
        lambda a, b: j_chunked(a, jnp.asarray(labels), lambda xc: xc @ b,
                               chunks=3), argnums=(0, 1))(x, w)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    lt = chunked_lm_loss(xt, torch.from_numpy(labels), lambda xc: xc @ wt,
                         chunks=3)
    gxt, gwt = torch.autograd.grad(lt, (xt, wt))
    np.testing.assert_allclose(lt.item(), float(lj), **F32)
    np.testing.assert_allclose(gxt.numpy(), np.asarray(gxj), **F32)
    np.testing.assert_allclose(gwt.numpy(), np.asarray(gwj), **F32)


# --------------------------------------------------------------------------
# AdamW and the train step


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_jax(weight_decay):
    rng = np.random.default_rng(2)
    params = {"a": rng.standard_normal((5, 3)).astype(np.float32),
              "b": {"c": rng.standard_normal(4).astype(np.float32)}}
    gs = [{"a": rng.standard_normal((5, 3)).astype(np.float32),
           "b": {"c": rng.standard_normal(4).astype(np.float32)}}
          for _ in range(3)]
    jopt = j_adamw(1e-2, weight_decay=weight_decay)
    topt = adamw(1e-2, weight_decay=weight_decay)
    jp, js = params, jopt.init(params)
    tp = from_jax_numpy(params)
    ts = topt.init(tp)
    for i, g in enumerate(gs):
        jp, js = jopt.update(g, js, jp, jnp.int32(i))
        tp, ts = topt.update(from_jax_numpy(g), ts, tp, i)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    for k in ("m", "v"):
        for a, b in zip(tree_leaves(ts[k]), jax.tree_util.tree_leaves(js[k])):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    bf = adamw(1e-2, state_dtype=torch.bfloat16).init(tp)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(bf))


@pytest.mark.parametrize("arch,sfpl", [("qwen3-8b", False),
                                       ("qwen3-8b", True),
                                       ("xlstm-1.3b", False)])
def test_train_step_matches_jax(arch, sfpl):
    """Two AdamW steps (the second with bias correction at t = 2 and
    non-zero moments) on converted JAX params and a JAX-drawn batch: the
    losses, the new params and the moments at <= 1e-5. The transformer
    runs with ``remat`` on (per-group recomputation in the backward); with
    ``sfpl`` the batch carries a JAX-drawn collector permutation.

    ``eps`` is 1e-4: Adam's step ``m / (sqrt(v) + eps)`` scales each
    element by ``1 / (|g| + eps)``, so the ~1e-7 float noise of a gradient
    element near ``eps`` moves the step by up to ``lr * 1e-7 / eps``; at
    the default 1e-8 two correct implementations differ by 1e-3 in the
    params (measured), at 1e-4 by under 1e-6. AdamW at its defaults is
    held by ``test_adamw_matches_jax`` and, on this model's first step,
    by ``test_train_step_default_eps_matches_jax``."""
    kw = {"remat": True} if arch == "qwen3-8b" else {}
    jspec, jcfg, tspec, tcfg, params, toks, labels = _setup(arch, **kw)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    if sfpl:
        jbatch["perm"] = jax.random.permutation(jax.random.PRNGKey(4), 4)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    jopt = j_adamw(1e-3, eps=1e-4, weight_decay=0.01)
    topt = adamw(1e-3, eps=1e-4, weight_decay=0.01)
    jstep = jax.jit(j_make_train_step(jspec, jcfg, jopt, sfpl=sfpl))
    tstep = make_train_step(tspec, tcfg, topt, sfpl=sfpl)
    jp, js, jt = params, jopt.init(params), jnp.zeros((), jnp.int32)
    tp = from_jax_numpy(params)
    ts, tt = topt.init(tp), 0
    for _ in range(2):
        jp, js, jt, jl = jstep(jp, js, jt, jbatch)
        tp, ts, tt, tl = tstep(tp, ts, tt, tbatch)
        np.testing.assert_allclose(float(tl), float(jl), **F32)
    assert tt == int(jt) == 2
    want = _host({"p": jp, "m": js["m"], "v": js["v"]})
    got = to_numpy({"p": tp, "m": ts["m"], "v": ts["v"]})
    for k in ("p", "m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(got[k]),
                        jax.tree_util.tree_leaves(want[k])):
            np.testing.assert_allclose(a, b, err_msg=k, **F32)


@pytest.mark.parametrize("arch", ["qwen3-8b", "xlstm-1.3b"])
def test_train_step_default_eps_matches_jax(arch):
    """One step of ``launch.train``'s optimizer, AdamW at its defaults
    (eps 1e-8) and lr 3e-3, on converted JAX params and a JAX-drawn batch.
    The loss and both moments are held at <= 1e-5 everywhere, the new
    params at <= 1e-5 wherever ``|g| > 1e-5`` (a thousand times eps).
    Below that, Adam's first step ``lr * g / (|g| + eps)`` turns the
    gradients' float noise into steps of up to ``lr`` that differ between
    two correct packages (see ``test_train_step_matches_jax``), so there
    each package's step is held to its bound ``lr``."""
    kw = {"remat": True} if arch == "qwen3-8b" else {}
    jspec, jcfg, tspec, tcfg, params, toks, labels = _setup(arch, **kw)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    lr, b1 = 3e-3, 0.9
    jopt, topt = j_adamw(lr, b1=b1), adamw(lr, b1=b1)
    jstep = jax.jit(j_make_train_step(jspec, jcfg, jopt))
    tstep = make_train_step(tspec, tcfg, topt)
    jp, js, _, jl = jstep(params, jopt.init(params),
                          jnp.zeros((), jnp.int32), jbatch)
    tp0 = from_jax_numpy(params)
    tp, ts, _, tl = tstep(tp0, topt.init(tp0), 0, tbatch)
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    want = _host({"p": jp, "m": js["m"], "v": js["v"]})
    got = to_numpy({"p": tp, "m": ts["m"], "v": ts["v"]})
    leaves = jax.tree_util.tree_leaves
    for k in ("m", "v"):
        for a, b in zip(leaves(got[k]), leaves(want[k])):
            np.testing.assert_allclose(a, b, err_msg=k, **F32)
    kept = total = 0
    for a, b, p0, m in zip(leaves(got["p"]), leaves(want["p"]),
                           leaves(params), leaves(want["m"])):
        big = np.abs(m) / (1 - b1) > 1e-5     # m = (1 - b1) g at step 0
        np.testing.assert_allclose(a[big], b[big], err_msg="p", **F32)
        for q in (a, b):
            assert np.all(np.abs(q - p0)[~big] <= lr * (1 + 1e-5))
        kept, total = kept + big.sum(), total + big.size
    assert kept > 0.9 * total, (kept, total)


def test_sfpl_lm_loss_matches_jax():
    """``sfpl_lm_loss`` with a JAX permutation (cut after the first of two
    groups): the loss and every gradient at <= 1e-5; the identity perm
    gives the plain loss (twin of tests/test_core.py's), and any perm
    leaves this batch-permutation-invariant loss equal."""
    jspec, jcfg, tspec, tcfg, params, toks, labels = _setup("qwen3-8b")
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(5), 4))
    assert not np.array_equal(perm, np.arange(4))
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: j_sfpl_lm_loss(jspec.model, p, jbatch, jcfg,
                                 perm=jnp.asarray(perm)),
        has_aux=True))(params)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    model = tspec.model
    p = with_grad(from_jax_numpy(params))
    lt, aux = sfpl_lm_loss(model, p, tbatch, tcfg,
                           perm=torch.from_numpy(np.array(perm)))
    assert set(aux) == {"xent", "aux"}
    np.testing.assert_allclose(lt.item(), float(lj), **F32)
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(grads(lt, p))),
                    jax.tree_util.tree_leaves(_host(gj))):
        np.testing.assert_allclose(a, b, **F32)
    with torch.no_grad():
        plain, _ = model.loss_fn(p, tbatch, tcfg)
        l_id, _ = sfpl_lm_loss(model, p, tbatch, tcfg,
                               perm=torch.arange(4))
        l_p, _ = sfpl_lm_loss(model, p, tbatch, tcfg,
                              perm=make_collector_perm(
                                  torch.Generator().manual_seed(0), 4))
    assert float(plain) == pytest.approx(float(l_id), abs=1e-5)
    assert float(plain) == pytest.approx(float(l_p), rel=1e-4)


def test_token_stream_obeys_the_recurrence():
    gen = torch.Generator().manual_seed(3)
    v = 97
    toks, labels = synthetic_token_stream(gen, batch=3, seq_len=20, vocab=v)
    assert toks.shape == labels.shape == (3, 20)
    assert toks.dtype == labels.dtype == torch.int32
    assert torch.equal(toks[:, 1:], labels[:, :-1])
    assert int(toks.min()) >= 0 and int(toks.max()) < v
    t = torch.cat([toks, labels[:, -1:]], dim=1).long()
    # next = (3 prev + 5 prev2 + offset + 7) % vocab, one offset a row
    offset = (t[:, 2] - 3 * t[:, 1] - 5 * t[:, 0] - 7) % v
    want = (3 * t[:, 1:-1] + 5 * t[:, :-2] + offset[:, None] + 7) % v
    assert torch.equal(t[:, 2:], want)
    again = synthetic_token_stream(torch.Generator().manual_seed(3),
                                   batch=3, seq_len=20, vocab=v)
    assert torch.equal(again[0], toks)


def test_train_checkpoint_eval_improves(tmp_path, capsys):
    """train_lm -> --ckpt -> launch.eval beats the untrained model of the
    same seed on held-out batches (twin of tests/test_substrate.py's)."""
    from repro_torch.launch.eval import evaluate_lm, main as eval_main
    from repro_torch.launch.train import main as train_main
    ckpt = str(tmp_path / "lm.npz")
    train_main(["--arch", "qwen3-8b", "--steps", "30", "--seq", "32",
                "--ckpt", ckpt, "--device", "cpu"])
    out = capsys.readouterr().out
    first, last = (float(x) for x in
                   out.split("first loss ")[1].split(" -> last loss "))
    assert last < first, out
    eval_main(["--arch", "qwen3-8b", "--ckpt", ckpt, "--batches", "2",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored step 30" in out
    trained = float(out.split("qwen3-8b: loss ")[1].split()[0])
    spec = get_arch("qwen3-8b")
    cfg = spec.make_smoke_config()
    p0 = spec.model.init(torch.Generator().manual_seed(0), cfg)
    before = evaluate_lm(spec, cfg, p0, batches=2)
    assert trained < before["loss"], (trained, before)
    assert 0.0 <= before["token_accuracy"] <= 1.0
