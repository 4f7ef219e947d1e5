"""The port's xLSTM path against the JAX package's on the same inputs (CPU):
K8's plain version, the layers and blocks, xlstm-1.3b's smoke prefill and
cached decode, and teacher-forced greedy decoding.

Inputs are made with numpy from a seed; parameters are drawn by the JAX
package's ``init`` and carried across through ``repro_torch.convert``.
Tolerances: K8's plain version 1e-5 of the JAX oracle ``slstm_scan_ref``
and 3e-4 of the Pallas kernel in interpret mode (tests/test_kernels.py's
kernel-to-ref bound); modules and blocks 1e-5 in f32 (the reference's own
f32 bound, tests/test_submesh.py); model logits 1e-4 in f32 (50 times
tighter than the reference's decode-to-forward bound,
tests/test_models_consistency.py); with bf16 compute 2e-2 relative to max
|logit| and elementwise within the JAX package's own bf16-to-f32 gap (as
tests/test_torch_lm.py holds qwen3-8b); greedy tokens exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.kernels.slstm_scan.ops import slstm_scan as j_slstm_scan
from repro.kernels.slstm_scan.ref import slstm_scan_ref as j_slstm_ref
from repro.launch.steps import (make_decode_step as j_decode_step,
                                make_prefill_step as j_prefill_step)
from repro.models import xlstm as JX
from repro.nn import linear as JL
from repro_torch import kernels as K
from repro_torch.configs import get_arch
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.kernels.slstm_scan import ops as slstm_ops
from repro_torch.kernels.slstm_scan import ref as slstm_ref
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import xlstm as TX
from repro_torch.nn import linear as TL

F32 = dict(atol=1e-5, rtol=1e-5)
LOGITS_F32 = dict(atol=1e-4, rtol=1e-4)


def _np(t):
    return t.detach().float().numpy()


def _jnp_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# the JAX config's memory policies (rematerialisation, a scan over the
# layer groups), which the port has no counterpart for
JAX_ONLY_FIELDS = {"remat", "scan_layers"}


def _port_cfg(jcfg, **kw):
    """The port's config with the JAX config's values for every field the
    port has (``pallas`` and ``pallas_interpret`` mean its ``kernel``)."""
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(TX.XLSTMConfig)}
    fields.update(kw)
    return TX.XLSTMConfig(**fields)


# --------------------------------------------------------------------------
# K8's plain version, on tests/test_kernels.py's grid (B 1-5, S 4/20/64/70,
# (H, Dh) in (2, 8), (4, 16), (1, 32)) plus the smoke config's Dh 64

@pytest.mark.parametrize("b,s,h,dh", [
    (1, 4, 2, 8), (2, 20, 4, 16), (3, 64, 1, 32), (4, 70, 2, 8),
    (5, 4, 4, 16), (5, 70, 1, 32), (1, 64, 4, 16), (3, 20, 2, 8),
    (2, 70, 2, 64)])
def test_slstm_scan_plain_matches_jax(b, s, h, dh):
    rng = np.random.default_rng(b * 31 + s + dh)
    pres = [_normal(rng, b, s, h, dh) for _ in range(4)]
    R = _normal(rng, 4, h, dh, dh, scale=0.3)
    zero = jnp.zeros((b, h, dh))
    state0 = (zero, zero + 1e-6, zero - 1e30, zero)
    want, want_final = j_slstm_ref(*map(jnp.asarray, pres), jnp.asarray(R),
                                   state0)
    got, final = slstm_ref.slstm_scan_ref(
        *map(torch.from_numpy, pres), torch.from_numpy(R),
        slstm_ref.initial_state(b, h, dh))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    for u, v in zip(final, want_final):
        np.testing.assert_allclose(_np(u), np.asarray(v), **F32)
    # the wrapper takes the plain version for CPU tensors; against the
    # Pallas kernel in interpret mode at its bound
    before = K.LAUNCHES["slstm_scan"]
    out = slstm_ops.slstm_scan(*map(torch.from_numpy, pres),
                               torch.from_numpy(R))
    assert K.LAUNCHES["slstm_scan"] == before      # no kernel on the CPU
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, s, h, dh)
    pallas = j_slstm_scan(*map(jnp.asarray, pres), jnp.asarray(R),
                          interpret=True)
    np.testing.assert_allclose(_np(out), np.asarray(pallas), rtol=3e-4,
                               atol=3e-4)


def test_slstm_scan_backward_raises():
    x = torch.zeros(1, 3, 1, 8, requires_grad=True)
    R = torch.zeros(4, 1, 8, 8)
    out = slstm_ops.slstm_scan(x, x, x, x, R)
    with pytest.raises(NotImplementedError, match="no VJP"):
        out.sum().backward()


# --------------------------------------------------------------------------
# layers and blocks (f32)

def test_dense_apply_promotes_mixed_dtypes_as_jax():
    """f32 inputs on bf16 weights give an f32 product (the xLSTM gates)."""
    rng = np.random.default_rng(0)
    x = _normal(rng, 3, 16)
    p = {"w": _normal(rng, 16, 8), "b": _normal(rng, 8)}
    pj = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in p.items()}
    pt = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    want = JL.dense_apply(pj, jnp.asarray(x))
    got = TL.dense_apply(pt, torch.from_numpy(x))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_causal_conv_and_blockdiag_match_jax():
    rng = np.random.default_rng(1)
    p = {"w": _normal(rng, 4, 24, scale=0.1), "b": _normal(rng, 24)}
    x = _normal(rng, 2, 9, 24)
    want = JX.causal_conv_apply(p, jnp.asarray(x))
    got = TX.causal_conv_apply(from_jax_numpy(p), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    buf = _normal(rng, 2, 3, 24)
    want_y, want_buf = JX.causal_conv_step(p, jnp.asarray(x[:, 0]),
                                           jnp.asarray(buf))
    got_y, got_buf = TX.causal_conv_step(from_jax_numpy(p),
                                         torch.from_numpy(x[:, 0]),
                                         torch.from_numpy(buf))
    np.testing.assert_allclose(_np(got_y), np.asarray(want_y), **F32)
    np.testing.assert_array_equal(_np(got_buf), np.asarray(want_buf))
    bd = {"w": _normal(rng, 6, 4, 4, scale=0.5)}
    want = JX.blockdiag_apply(bd, jnp.asarray(x))
    got = TX.blockdiag_apply(from_jax_numpy(bd), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("s,chunk", [(16, 4), (12, 12)])
def test_mlstm_chunk_scan_matches_jax(s, chunk):
    rng = np.random.default_rng(s + chunk)
    b, h, d = 2, 2, 8
    q, k, v = (_normal(rng, b, h, s, d) for _ in range(3))
    i_pre = _normal(rng, b, h, s)
    logf = np.array(jax.nn.log_sigmoid(jnp.asarray(_normal(rng, b, h, s)
                                                    + 2.0)))
    want = JX._mlstm_chunk_scan(*map(jnp.asarray, (q, k, v, i_pre, logf)),
                                chunk=chunk)
    got = TX._mlstm_chunk_scan(*map(torch.from_numpy, (q, k, v, i_pre,
                                                       logf)), chunk=chunk)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_mlstm_recurrent_step_matches_jax():
    rng = np.random.default_rng(3)
    b, h, d = 2, 2, 8
    state = (_normal(rng, b, h, d, d), _normal(rng, b, h, d),
             _normal(rng, b, h))
    args = [_normal(rng, b, h, d) for _ in range(3)] + [
        _normal(rng, b, h), _normal(rng, b, h) - 1.0]
    (wC, wn, wm), wh = JX.mlstm_recurrent_step(
        tuple(map(jnp.asarray, state)), *map(jnp.asarray, args))
    (gC, gn, gm), gh = TX.mlstm_recurrent_step(
        tuple(map(torch.from_numpy, state)), *map(torch.from_numpy, args))
    for u, v in ((gC, wC), (gn, wn), (gm, wm), (gh, wh)):
        np.testing.assert_allclose(_np(u), np.asarray(v), **F32)


@pytest.fixture(scope="module")
def smoke():
    """xlstm-1.3b's smoke config (2 blocks: an mLSTM and an sLSTM, d 128,
    2 heads, Dh 64), f32 compute, params drawn by JAX."""
    jspec = j_get_arch("xlstm-1.3b")
    jcfg = jspec.make_smoke_config(compute_dtype="float32")
    params = _jnp_tree(jspec.model.init(jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(11).integers(0, jcfg.vocab_size,
                                              (2, 16)).astype(np.int32)
    return jspec, jcfg, params, toks


def _block(params, p_idx):
    return jax.tree_util.tree_map(lambda a: a[0],
                                  params["layers"][f"sub{p_idx}"])


def test_mlstm_block_matches_jax(smoke):
    _, jcfg, params, _ = smoke
    tcfg = _port_cfg(jcfg)
    lp = _block(params, 0)
    x = _normal(np.random.default_rng(4), 2, 16, jcfg.d_model)
    want = JX.mlstm_block_apply(lp, jnp.asarray(x), jcfg)
    got = TX.mlstm_block_apply(from_jax_numpy(lp), torch.from_numpy(x),
                               tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    jst = JX.mlstm_state_init(jcfg, 2)
    tst = TX.mlstm_state_init(tcfg, 2)
    for t in range(3):
        wd, jst = JX.mlstm_block_step(lp, jnp.asarray(x[:, t:t + 1]), jst,
                                      jcfg)
        gd, tst = TX.mlstm_block_step(from_jax_numpy(lp),
                                      torch.from_numpy(x[:, t:t + 1]), tst,
                                      tcfg)
        np.testing.assert_allclose(_np(gd), np.asarray(wd), **F32)
        for name in ("conv_buf", "C", "n", "m"):
            np.testing.assert_allclose(_np(tst[name]),
                                       np.asarray(jst[name]), **F32)


@pytest.mark.parametrize("jax_impl,port_impl", [
    ("xla", "xla"), ("xla", "kernel"), ("pallas_interpret", "kernel")])
def test_slstm_block_matches_jax(smoke, jax_impl, port_impl):
    _, jcfg, params, _ = smoke
    jcfg = dataclasses.replace(jcfg, slstm_impl=jax_impl)
    tcfg = _port_cfg(jcfg, slstm_impl=port_impl)
    lp = _block(params, 1)
    x = _normal(np.random.default_rng(5), 2, 10, jcfg.d_model)
    want = JX.slstm_block_apply(lp, jnp.asarray(x), jcfg)
    got = TX.slstm_block_apply(from_jax_numpy(lp), torch.from_numpy(x),
                               tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_slstm_block_step_matches_jax(smoke):
    _, jcfg, params, _ = smoke
    tcfg = _port_cfg(jcfg)
    lp = _block(params, 1)
    x = _normal(np.random.default_rng(6), 2, 4, jcfg.d_model)
    jst = JX.slstm_state_init(jcfg, 2)
    tst = TX.slstm_state_init(tcfg, 2)
    for t in range(4):
        wd, jst = JX.slstm_block_step(lp, jnp.asarray(x[:, t:t + 1]), jst,
                                      jcfg)
        gd, tst = TX.slstm_block_step(from_jax_numpy(lp),
                                      torch.from_numpy(x[:, t:t + 1]), tst,
                                      tcfg)
        np.testing.assert_allclose(_np(gd), np.asarray(wd), **F32)
        for name in ("c", "n", "m", "h"):
            np.testing.assert_allclose(_np(tst[name]),
                                       np.asarray(jst[name]), **F32)


# --------------------------------------------------------------------------
# the model

def test_port_init_has_jax_tree_structure(smoke):
    _, jcfg, params, _ = smoke
    ours = jax.tree_util.tree_flatten_with_path(to_numpy(TX.init(
        torch.Generator().manual_seed(0), _port_cfg(jcfg))))[0]
    theirs = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, u), (_, v) in zip(ours, theirs):
        assert u.shape == v.shape and u.dtype == v.dtype, path


@pytest.mark.parametrize("jax_impl,port_impl", [
    ("xla", "xla"), ("xla", "kernel"), ("pallas_interpret", "kernel")])
def test_prefill_logits_match_jax_f32(smoke, jax_impl, port_impl):
    jspec, jcfg, params, toks = smoke
    jcfg = dataclasses.replace(jcfg, slstm_impl=jax_impl)
    tcfg = _port_cfg(jcfg, slstm_impl=port_impl)
    tspec = get_arch("xlstm-1.3b")
    want = jax.jit(j_prefill_step(jspec, jcfg))(
        params, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(tspec, tcfg)(from_jax_numpy(params),
                                         {"tokens": torch.from_numpy(toks)})
    assert tuple(got.shape) == want.shape == (2, 1, jcfg.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGITS_F32)
    # every position, through the forward
    want, _ = JX.forward(params, {"tokens": jnp.asarray(toks)}, jcfg,
                         training=False)
    got, _ = TX.forward(from_jax_numpy(params),
                        {"tokens": torch.from_numpy(toks)}, tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGITS_F32)


def test_prefill_logits_match_jax_bf16(smoke):
    """bf16 compute, each sLSTM path against its JAX counterpart: within
    2e-2 of the JAX package's bf16 logits relative to max |logit|, and
    elementwise no farther from them than the JAX package's own bf16
    logits are from its f32 logits (``pytest -s`` prints the gaps)."""
    jspec, jcfg, params, toks = smoke
    batch = {"tokens": jnp.asarray(toks)}
    exact = np.asarray(jax.jit(j_prefill_step(jspec, jcfg))(params, batch))
    tp = from_jax_numpy(params)
    for jax_impl in ("xla", "pallas_interpret"):
        bcfg = dataclasses.replace(jcfg, compute_dtype="bfloat16",
                                   slstm_impl=jax_impl)
        tcfg = _port_cfg(bcfg)
        assert tcfg.cdtype() == torch.bfloat16
        want = np.asarray(jax.jit(j_prefill_step(jspec, bcfg))(params,
                                                                batch))
        own = float(np.abs(want - exact).max())
        got = make_prefill_step(get_arch("xlstm-1.3b"), tcfg)(
            tp, {"tokens": torch.from_numpy(toks)})
        assert got.shape == want.shape
        gap = float(np.abs(_np(got) - want).max())
        scale = float(np.abs(want).max())
        print(f"bf16 logits, {tcfg.slstm_impl}: port vs JAX {gap:.4e} "
              f"(max |logit| {scale:.3f}); JAX bf16 vs JAX f32 {own:.4e}")
        assert gap <= 2e-2 * scale, (jax_impl, gap, scale)
        assert gap <= own, (jax_impl, gap, own)


def test_decode_logits_match_jax_f32(smoke):
    """Cached decode over 8 steps (the state stacked per group), against
    the JAX package's ``decode_step``."""
    jspec, jcfg, params, toks = smoke
    tcfg = _port_cfg(jcfg)
    tspec = get_arch("xlstm-1.3b")
    jstate = jspec.model.init_decode_state(jcfg, 2)
    tstate = tspec.model.init_decode_state(tcfg, 2)
    jstep = jax.jit(j_decode_step(jspec, jcfg))
    tstep = make_decode_step(tspec, tcfg)
    tp = from_jax_numpy(params)
    for t in range(8):
        want, jstate = jstep(params, jstate, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        got, tstate = tstep(tp, tstate, torch.from_numpy(toks[:, t:t + 1]),
                            t)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGITS_F32)


def test_teacher_forced_greedy_tokens_match_jax(smoke):
    """The serve loop: a 5-token prompt teacher-forced through decode, then
    6 greedy tokens; the same tokens as the JAX package."""
    jspec, jcfg, params, toks = smoke
    tcfg = _port_cfg(jcfg)
    tspec = get_arch("xlstm-1.3b")
    prompt, gen = toks[:, :5], 6
    jstate = jspec.model.init_decode_state(jcfg, 2)
    tstate = tspec.model.init_decode_state(tcfg, 2)
    jstep = jax.jit(j_decode_step(jspec, jcfg))
    tp = from_jax_numpy(params)
    jout, tout = [], []
    for t in range(prompt.shape[1] + gen - 1):
        jcur = prompt[:, t:t + 1] if t < prompt.shape[1] else jout[-1]
        tcur = prompt[:, t:t + 1] if t < prompt.shape[1] else tout[-1]
        jl, jstate = jstep(params, jstate, jnp.asarray(jcur), jnp.int32(t))
        tl, tstate = tspec.model.decode_step(tp, tstate,
                                             torch.from_numpy(tcur), tcfg)
        if t >= prompt.shape[1] - 1:
            jout.append(np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
                        .astype(np.int32))
            tout.append(tl[:, -1].argmax(-1, keepdim=True).numpy()
                        .astype(np.int32))
    assert np.array_equal(np.concatenate(tout, 1), np.concatenate(jout, 1))


def test_config_takes_the_jax_kernel_names():
    for name in ("kernel", "pallas", "pallas_interpret"):
        assert TX.XLSTMConfig(slstm_impl=name).slstm_impl == "kernel"
    assert TX.XLSTMConfig().slstm_impl == "xla"
    with pytest.raises(ValueError, match="slstm_impl"):
        TX.XLSTMConfig(slstm_impl="triton")


def test_full_config_matches_jax_and_training_raises(smoke):
    """xlstm-1.3b's full config carries the JAX package's fields; training
    (``loss_fn``) names the LM-training slice."""
    jcfg = j_get_arch("xlstm-1.3b").make_config()
    tcfg = get_arch("xlstm-1.3b").make_config()
    ours, theirs = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    assert set(theirs) - set(ours) == JAX_ONLY_FIELDS
    assert ours == {k: theirs[k] for k in ours}
    assert (tcfg.num_layers // tcfg.slstm_every, tcfg.d_inner,
            tcfg.head_dim) == (6, 4096, 1024)
    _, scfg, params, toks = smoke
    with pytest.raises(NotImplementedError, match="LM-training slice"):
        TX.loss_fn(from_jax_numpy(params),
                   {"tokens": torch.from_numpy(toks),
                    "labels": torch.from_numpy(toks)}, _port_cfg(scfg))


def test_serve_runs_the_xlstm_on_the_cpu():
    from repro_torch.launch.serve import serve
    out = serve("xlstm-1.3b", batch=2, prompt_len=4, gen=3, device="cpu")
    assert tuple(out.shape) == (2, 3) and out.dtype == torch.int64
    assert int(out.min()) >= 0 and int(out.max()) < 512
