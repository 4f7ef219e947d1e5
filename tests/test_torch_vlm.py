"""The port's VLM backbone (qwen2-vl-7b: M-RoPE, stub vision embeddings
merged after BOS) against the JAX package's on the same inputs (CPU):
M-RoPE and its positions, attention under M-RoPE, smoke prefill with
vision embeddings through both attention paths, cached decode, the
scheduler's greedy tokens, one SGD train step, the launchers and the full
config's size.

Inputs are made with numpy from a seed; parameters are drawn by the JAX
package's ``init`` and carried across through ``repro_torch.convert``.
Tolerances as tests/test_torch_lm.py's: 1e-5 for a module in f32, 1e-4
for logits in f32; positions and token ids equal.

The two attention paths differ in the JAX package itself under M-RoPE:
its ``xla`` path masks by the temporal ids, which every vision token
shares, so the vision block attends both ways; its Pallas path masks by
index. The port's ``xla`` path is held against JAX's ``xla`` and its
kernel path against ``pallas_interpret``, never across (ROADMAP
section 3).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch.steps import make_prefill_step as j_prefill_step
from repro.models import transformer as JT
from repro.nn import attention as JA
from repro.nn import rope as JR
from repro.optim import sgd_momentum as j_sgd
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.launch.steps import make_prefill_step, make_train_step
from repro_torch.models import transformer as T
from repro_torch.nn import attention as TA
from repro_torch.nn import rope as TR
from repro_torch.optim import sgd_momentum
from repro_torch.tree import grads, tree_leaves, with_grad
from test_torch_lm import (LOGITS_F32, _cfgs, _check_batcher_greedy,
                           _check_decode_f32, _jnp_tree, _np, _normal)
from test_torch_lm_train import _host, _one_thread, _setup  # noqa: F401

F32 = dict(atol=1e-5, rtol=1e-5)
ARCH = "qwen2-vl-7b"
# the smoke config's 16 vision tokens after BOS leave 15 text positions
SEQ = 32


# --------------------------------------------------------------------------
# M-RoPE

@pytest.mark.parametrize("batch,seq,nv", [(2, 32, 16), (1, 20, 7),
                                          (2, 8, 0), (1, 40, 1024),
                                          (2, 1100, 1024)])
def test_build_mrope_positions_matches_jax(batch, seq, nv):
    """Equal ids: the vision grid (non-square at 7 tokens; past the
    sequence at 1,024 over 40) and the text after it."""
    want = np.asarray(JT.build_mrope_positions(batch, seq, nv))
    got = T.build_mrope_positions(batch, seq, nv)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("head_dim,sections", [(128, (16, 24, 24)),
                                               (64, (16, 8, 8))])
def test_apply_mrope_matches_jax(head_dim, sections):
    """Within 1e-5 of the JAX package (as ``apply_rope`` is: the two
    frameworks' cos and sin differ in the last bits), and the section
    select exact: each channel is the 1-D rotation by its section's
    position stream, bit for bit, and text ids give 1-D RoPE bit for
    bit."""
    rng = np.random.default_rng(0)
    x = _normal(rng, 2, 24, 3, head_dim)
    pos = np.asarray(JT.build_mrope_positions(2, 24, 9)).copy()
    pos[:, 1] += rng.integers(0, 4096, (3, 1)).astype(np.int32)
    want = JR.apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta=1e6,
                          sections=sections)
    tx, tpos = torch.from_numpy(x), torch.from_numpy(pos)
    got = TR.apply_mrope(tx, tpos, theta=1e6, sections=sections)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    half = head_dim // 2
    sec = np.repeat(np.arange(3), sections)
    for k in range(3):
        one = TR.apply_rope(tx, tpos[k], theta=1e6)
        for c in np.flatnonzero(sec == k):
            assert torch.equal(got[..., c], one[..., c])
            assert torch.equal(got[..., c + half], one[..., c + half])
    text = tpos[0].expand(3, -1, -1)
    assert torch.equal(TR.apply_mrope(tx, text, theta=1e6,
                                      sections=sections),
                       TR.apply_rope(tx, tpos[0], theta=1e6))
    with pytest.raises(AssertionError):
        TR.apply_mrope(tx, tpos, sections=(16, 16, 16))
    assert TR.mrope_positions(tpos) is tpos


def _mrope_cfgs():
    base = dict(d_model=32, num_heads=4, num_kv_heads=2, head_dim=8,
                use_bias=True, rope_theta=1e6, mrope_sections=(2, 1, 1))
    return JA.AttnConfig(**base), TA.AttnConfig(**base)


def test_mrope_attention_matches_jax():
    """The ``xla`` path under (3, B, S) positions, masked by the temporal
    ids, and decode token by token with (3, B, 1) positions."""
    jc, tc = _mrope_cfgs()
    p = _jnp_tree(JA.attention_init(jax.random.PRNGKey(1), jc))
    p = jax.tree_util.tree_map(   # non-zero qkv biases
        lambda a: a + 0.1 * np.random.default_rng(2).standard_normal(
            a.shape).astype(np.float32), p)
    tp = from_jax_numpy(p)
    rng = np.random.default_rng(3)
    x = _normal(rng, 2, 12, 32)
    pos = np.asarray(JT.build_mrope_positions(2, 12, 4))
    want = jax.jit(lambda p_, x_, pos_: JA.attention_apply(
        p_, x_, jc, positions=pos_))(p, jnp.asarray(x), jnp.asarray(pos))
    got = TA.attention_apply(tp, torch.from_numpy(x), tc,
                             positions=torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    jcache = JA.init_kv_cache(2, 8, 2, 8, dtype=jnp.float32)
    tcache = TA.init_kv_cache(2, 8, 2, 8, dtype=torch.float32)
    jdecode = jax.jit(lambda p_, x_, c_, t_: JA.attention_decode(
        p_, x_, jc, cache=c_, cur_pos=t_))
    for t in range(6):
        xt = _normal(rng, 2, 1, 32)
        want, jcache = jdecode(p, jnp.asarray(xt), jcache, jnp.int32(t))
        got, tcache = TA.attention_decode(tp, torch.from_numpy(xt), tc,
                                          cache=tcache, cur_pos=t)
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


# --------------------------------------------------------------------------
# the smoke model

@pytest.fixture(scope="module")
def vlm():
    """The smoke config (2 layers, d 256, 16 vision tokens), params drawn
    by JAX, tokens (2, SEQ) and vision embeddings (2, 16, 256)."""
    jspec = j_get_arch(ARCH)
    cfg = jspec.make_smoke_config(compute_dtype="float32")
    params = _jnp_tree(jspec.model.init(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, SEQ)).astype(np.int32)
    ve = _normal(rng, 2, cfg.vision_tokens, cfg.d_model)
    return jspec, params, toks, ve


def _logits(vlm, jax_impl, port_impl, last_token_only=True):
    """(JAX's, the port's) f32 logits of the smoke prefill with vision
    embeddings, every position unless ``last_token_only``."""
    jspec, params, toks, ve = vlm
    jcfg, tspec, tcfg = _cfgs(jspec, compute_dtype="float32",
                              attention_impl=jax_impl)
    tcfg = dataclasses.replace(tcfg, attention_impl=port_impl)
    jb = {"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(ve)}
    tb = {"tokens": torch.from_numpy(toks),
          "vision_embeds": torch.from_numpy(ve)}
    if last_token_only:
        want = jax.jit(j_prefill_step(jspec, jcfg))(params, jb)
        got = make_prefill_step(tspec, tcfg)(from_jax_numpy(params), tb)
    else:
        want, _ = jax.jit(lambda p, b: jspec.model.forward(
            p, b, jcfg, training=False))(params, jb)
        got, _ = tspec.model.forward(from_jax_numpy(params), tb, tcfg)
    return np.asarray(want), _np(got)


@pytest.mark.parametrize("jax_impl,port_impl", [("xla", "xla"),
                                                ("pallas_interpret",
                                                 "kernel")])
def test_vlm_prefill_logits_match_jax_f32(vlm, jax_impl, port_impl):
    want, got = _logits(vlm, jax_impl, port_impl)
    assert got.shape == want.shape == (2, 1, 512)
    np.testing.assert_allclose(got, want, **LOGITS_F32)


def test_vlm_attention_paths_differ_as_in_jax(vlm):
    """The port's ``xla``-against-kernel gap over every position is the
    JAX package's ``xla``-against-``pallas_interpret`` gap: large (the
    vision block's two-way attention against a causal one), and equal
    element by element within the sum of the two logits tolerances.
    ``pytest -s`` prints both gaps."""
    jx, tx = _logits(vlm, "xla", "xla", last_token_only=False)
    jk, tk = _logits(vlm, "pallas_interpret", "kernel",
                     last_token_only=False)
    np.testing.assert_allclose(tx, jx, **LOGITS_F32)
    np.testing.assert_allclose(tk, jk, **LOGITS_F32)
    gap_j, gap_t = jx - jk, tx - tk
    print(f"xla against the kernel path, max |diff|: JAX "
          f"{np.abs(gap_j).max():.4f}, the port {np.abs(gap_t).max():.4f}")
    assert np.abs(gap_j).max() > 0.1, np.abs(gap_j).max()
    np.testing.assert_allclose(gap_t, gap_j, atol=2e-4, rtol=2e-4)
    # the vision block and BOS aside, position 0 sees only itself on both
    assert np.abs(gap_t[:, 0]).max() < 1e-5


def test_vlm_decode_logits_match_jax_f32(vlm):
    """Text tokens through the cache with (3, B, 1) M-RoPE positions."""
    jspec, params, toks, _ = vlm
    _check_decode_f32((jspec, params, toks[:, :12]))


def test_vlm_continuous_batcher_greedy_matches_jax(vlm):
    jspec, params, toks, _ = vlm
    _check_batcher_greedy((jspec, params, toks))


def test_embed_inputs_merges_vision_after_bos(vlm):
    """The vision embeddings take positions 1..16 (position 0 when they
    fill the sequence, where ``dynamic_update_slice`` clamps), equal to
    the JAX package's bit for bit; more than fit raise."""
    jspec, params, toks, ve = vlm
    jcfg, _, tcfg = _cfgs(jspec, compute_dtype="float32")
    tp = from_jax_numpy(params)
    for s in (SEQ, 17, 16):
        jb = {"tokens": jnp.asarray(toks[:, :s]),
              "vision_embeds": jnp.asarray(ve)}
        tb = {"tokens": torch.from_numpy(toks[:, :s]),
              "vision_embeds": torch.from_numpy(ve)}
        want = np.asarray(JT.embed_inputs(params, jb, jcfg))
        got = T.embed_inputs(tp, tb, tcfg)
        assert np.array_equal(_np(got), want), s
        lo = min(1, s - 16)
        assert np.array_equal(_np(got[:, lo:lo + 16]), ve)
    with pytest.raises(ValueError, match="do not fit"):
        T.embed_inputs(tp, {"tokens": torch.from_numpy(toks[:, :8]),
                            "vision_embeds": torch.from_numpy(ve)}, tcfg)


def test_vlm_train_step_matches_jax():
    """One SGD step (momentum 0.9) with ``remat`` on and vision
    embeddings in the batch: the loss, every gradient and the new params
    at <= 1e-5."""
    jspec, jcfg, tspec, tcfg, params, toks, labels = _setup(
        ARCH, seq=SEQ, remat=True)
    ve = _normal(np.random.default_rng(12), 4, jcfg.vision_tokens,
                 jcfg.d_model)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
              "vision_embeds": jnp.asarray(ve)}
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: jspec.model.loss_fn(p, jbatch, jcfg), has_aux=True))(params)
    p = with_grad(from_jax_numpy(params))
    lt, _ = tspec.model.loss_fn(p, tbatch, tcfg)
    np.testing.assert_allclose(lt.item(), float(lj), **F32)
    for a, b in zip(tree_leaves(to_numpy(grads(lt, p))),
                    jax.tree_util.tree_leaves(_host(gj))):
        np.testing.assert_allclose(a, b, **F32)
    jopt, topt = j_sgd(1e-2, momentum=0.9), sgd_momentum(1e-2, momentum=0.9)
    jp, _ = jopt.update(gj, jopt.init(params), params, 0)
    tp0 = from_jax_numpy(params)
    tp, _, _, tl = make_train_step(tspec, tcfg, topt)(
        tp0, topt.init(tp0), 0, tbatch)
    np.testing.assert_allclose(float(tl), float(lj), **F32)
    for a, b in zip(tree_leaves(to_numpy(tp)),
                    jax.tree_util.tree_leaves(_host(jp))):
        np.testing.assert_allclose(a, b, **F32)


# --------------------------------------------------------------------------
# the launchers and the full config

def test_train_lm_and_evaluate_lm_run_qwen2_vl(tmp_path, capsys):
    """``launch.train --arch qwen2-vl-7b`` (smoke, CPU, vision embeddings
    drawn a batch) trains and checkpoints; ``launch.eval`` restores and
    evaluates it."""
    from repro_torch.launch.eval import main as eval_main
    from repro_torch.launch.train import main as train_main
    ckpt = str(tmp_path / "vl.npz")
    train_main(["--arch", ARCH, "--steps", "6", "--seq", str(SEQ),
                "--batch", "4", "--ckpt", ckpt, "--device", "cpu"])
    out = capsys.readouterr().out
    first, last = (float(x) for x in
                   out.split("first loss ")[1].split(" -> last loss "))
    assert math.isfinite(first) and last < first, out
    eval_main(["--arch", ARCH, "--ckpt", ckpt, "--batches", "1",
               "--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored step 6" in out
    assert math.isfinite(float(out.split(f"{ARCH}: loss ")[1].split()[0]))


def test_serve_runs_qwen2_vl():
    from repro_torch.launch.serve import serve
    out = serve(ARCH, batch=2, prompt_len=4, gen=3, device="cpu")
    assert tuple(out.shape) == (2, 3)
    assert 0 <= int(out.min()) and int(out.max()) < 512


def test_full_config_param_count():
    """7.6 B as the model card (tests/test_arch_smoke.py), counted on the
    meta device, with the JAX package's leaf shapes."""
    from repro_torch.configs import get_arch
    spec = get_arch(ARCH)
    with torch.device("meta"):
        params = spec.model.init(None, spec.make_config())
    n = sum(t.numel() for t in tree_leaves(params))
    assert abs(n / 1e9 - 7.6) / 7.6 < 0.03, n / 1e9
    jspec = j_get_arch(ARCH)
    shapes = jax.eval_shape(lambda: jspec.model.init(jax.random.PRNGKey(0),
                                                     jspec.make_config()))
    assert [tuple(t.shape) for t in tree_leaves(params)] == [
        tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)]
