"""The port's encoder-decoder (whisper-large-v3) against the JAX package's
on the same inputs (CPU): the layer norm, the sinusoidal table, the smoke
model's prefill on both attention paths, encode -> prefill_cross -> cached
decode, one SGD train step, the learned positions' end, the launchers, the
full config's size, the parameter tree's round trip; and the registry's
``input_specs`` for all ten architectures.

Inputs are made with numpy from a seed; parameters are drawn by the JAX
package's ``init`` and carried across through ``repro_torch.convert``.
Tolerances are those of tests/test_torch_lm.py and
tests/test_torch_lm_train.py: modules, losses, gradients and params 1e-5
in f32, model logits 1e-4 in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES, get_arch as j_get_arch
from repro.configs.registry import input_specs as j_input_specs
from repro.launch.steps import (make_decode_step as j_decode_step,
                                make_prefill_step as j_prefill_step)
from repro.models import whisper as JW
from repro.nn import norm as JN
from repro.optim import sgd_momentum as j_sgd
from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.configs.registry import input_specs
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import whisper as TW
from repro_torch.nn import norm as TN
from repro_torch.optim import sgd_momentum
from repro_torch.tree import grads, tree_leaves, with_grad
from test_torch_lm import (F32, IMPL_PAIRS, LOGITS_F32, _jnp_tree, _normal,
                           _np)
from test_torch_lm_train import _host, _one_thread  # noqa: F401
from test_torch_rglru import _check_train_eval

ARCH = "whisper-large-v3"
FRAMES = 16


def _cfgs(jax_impl="xla", port_impl="xla", **kw):
    """The JAX smoke config in f32 (``kw`` overrides; 2 layers a side, d
    128, head_dim 32, 32 learned positions) and the port's with the same
    fields, on ``port_impl``'s attention path."""
    jcfg = dataclasses.replace(j_get_arch(ARCH).make_smoke_config(
        compute_dtype="float32", attention_impl=jax_impl), **kw)
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(TW.WhisperConfig)}
    fields["attention_impl"] = port_impl
    return jcfg, TW.WhisperConfig(**fields)


@pytest.fixture(scope="module")
def smoke():
    """Params drawn by JAX, frame embeddings (2, 16, 128) and tokens (2,
    20)."""
    jcfg, _ = _cfgs()
    params = _jnp_tree(JW.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(11)
    frames = _normal(rng, 2, FRAMES, jcfg.d_model)
    toks = rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    return params, frames, toks


def _batches(frames, toks):
    j = {"frame_embeds": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    t = {"frame_embeds": torch.from_numpy(frames),
         "tokens": torch.from_numpy(toks)}
    return j, t


# --------------------------------------------------------------------------
# layers

def test_layernorm_apply_matches_jax():
    """Mean and biased variance in f32 on rows far from zero mean; the
    result in the input's dtype."""
    rng = np.random.default_rng(1)
    x = 3.0 + 2.0 * _normal(rng, 3, 5, 100)
    p = {"scale": 1.0 + 0.1 * _normal(rng, 100), "bias": _normal(rng, 100)}
    tp = from_jax_numpy(p)
    want = JN.layernorm_apply(p, jnp.asarray(x), eps=1e-5)
    got = TN.layernorm_apply(tp, torch.from_numpy(x), eps=1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    got16 = TN.layernorm_apply(tp, torch.from_numpy(x).bfloat16())
    assert got16.dtype == torch.bfloat16
    init = TN.layernorm_init(torch.Generator(), 100)
    assert sorted(init) == ["bias", "scale"]
    assert bool((init["scale"] == 1).all() and (init["bias"] == 0).all())


@pytest.mark.parametrize("length,dim", [(32, 128), (1500, 1280)])
def test_sinusoidal_positions_match_jax(length, dim):
    """The smoke config's table within 1e-5. At whisper-large-v3's 1,500
    frames an angle reaches 1,499 rad, where one f32 ulp of ``exp``'s
    frequency (XLA's and torch's may round apart) moves it by 1.8e-4: the
    full table is held within two f32 ulps of its largest angle."""
    want = np.asarray(JW.sinusoidal_positions(length, dim))
    got = TW.sinusoidal_positions(length, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == (length, dim)
    tol = (F32 if length <= 32 else
           dict(rtol=0, atol=2 * (length - 1) * np.finfo(np.float32).eps))
    np.testing.assert_allclose(_np(got), want, **tol)


# --------------------------------------------------------------------------
# the smoke model

@pytest.mark.parametrize("jax_impl,port_impl", IMPL_PAIRS)
def test_whisper_prefill_logits_match_jax_f32(smoke, jax_impl, port_impl):
    """Every position's logits (and the prefill step's last one) at 16
    frames x 20 tokens: the encoder's self-attention non-causal, the
    decoder's causal, cross-attention on the plain path on both."""
    params, frames, toks = smoke
    jcfg, tcfg = _cfgs(jax_impl, port_impl)
    jb, tb = _batches(frames, toks)
    want, _ = jax.jit(lambda p, b: JW.forward(p, b, jcfg, training=False))(
        params, jb)
    tp = from_jax_numpy(params)
    got, _ = TW.forward(tp, tb, tcfg)
    assert tuple(got.shape) == want.shape == (2, 20, jcfg.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGITS_F32)
    last = make_prefill_step(get_arch(ARCH), tcfg)(tp, tb)
    jlast = jax.jit(j_prefill_step(j_get_arch(ARCH), jcfg))(params, jb)
    np.testing.assert_allclose(_np(last), np.asarray(jlast), **LOGITS_F32)


def test_whisper_decode_logits_match_jax_f32(smoke):
    """``encode`` -> ``prefill_cross`` -> one ``decode_step`` a token,
    against the JAX package's, and the port's decode against its own
    forward."""
    params, frames, toks = smoke
    jcfg, tcfg = _cfgs()
    jspec, tspec = j_get_arch(ARCH), get_arch(ARCH)
    tp = from_jax_numpy(params)
    jenc = JW.encode(params, jnp.asarray(frames), jcfg, training=False)
    tenc = TW.encode(tp, torch.from_numpy(frames), tcfg)
    np.testing.assert_allclose(_np(tenc), np.asarray(jenc), **F32)
    jstate = JW.prefill_cross(params, jenc, JW.init_decode_state(
        jcfg, 2, 20, dtype=jnp.float32, enc_frames=FRAMES), jcfg)
    tstate = TW.prefill_cross(tp, tenc, TW.init_decode_state(
        tcfg, 2, 20, dtype=torch.float32, enc_frames=FRAMES), tcfg)
    for name in ("cross_k", "cross_v"):
        assert tstate[name].shape == (2, 2, FRAMES, 4, 32)
        np.testing.assert_allclose(_np(tstate[name]),
                                   np.asarray(jstate[name]), **F32)
    jstep = jax.jit(j_decode_step(jspec, jcfg))
    tstep = make_decode_step(tspec, tcfg)
    dec = []
    for t in range(toks.shape[1]):
        want, jstate = jstep(params, jstate, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        got, tstate = tstep(tp, tstate, torch.from_numpy(toks[:, t:t + 1]),
                            t)
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGITS_F32)
        dec.append(got)
    fwd, _ = TW.forward(tp, _batches(frames, toks)[1], tcfg)
    np.testing.assert_allclose(_np(torch.cat(dec, dim=1)), _np(fwd),
                               **LOGITS_F32)


def test_positions_past_the_table_raise_where_jax_gives_nan(smoke):
    """Past ``max_target_positions`` (32 in the smoke config) the JAX
    package's gather fills NaN; the port's ``decode_train``,
    ``decode_step`` and ``serve`` raise ``ValueError`` naming it."""
    params, frames, _ = smoke
    jcfg, tcfg = _cfgs()
    toks = np.zeros((2, 40), np.int32)
    jb, tb = _batches(frames, toks)
    want, _ = JW.forward(params, jb, jcfg, training=False)
    assert bool(np.isnan(np.asarray(want)).any())
    tp = from_jax_numpy(params)
    with pytest.raises(ValueError, match="max_target_positions=32"):
        TW.forward(tp, tb, tcfg)
    jstate = JW.init_decode_state(jcfg, 2, 40, dtype=jnp.float32,
                                  enc_frames=FRAMES)
    jlog, _ = JW.decode_step(params, jstate, jnp.zeros((2, 1), jnp.int32),
                             jcfg, cur_pos=32)
    assert bool(np.isnan(np.asarray(jlog)).all())
    tstate = TW.init_decode_state(tcfg, 2, 40, dtype=torch.float32,
                                  enc_frames=FRAMES)
    one = torch.zeros((2, 1), dtype=torch.long)
    with pytest.raises(ValueError, match="max_target_positions=32"):
        TW.decode_step(tp, tstate, one, tcfg, cur_pos=32)
    TW.decode_step(tp, tstate, one, tcfg, cur_pos=31)     # the last one
    from repro_torch.launch.serve import serve
    with pytest.raises(ValueError, match="max_target_positions=32"):
        serve(ARCH, batch=2, prompt_len=30, gen=4, device="cpu")


def test_whisper_train_step_matches_jax():
    """One SGD step (momentum 0.9), the port's with ``remat`` on (JAX's
    reference without it; remat changes no value): the loss, every
    gradient and the new params at <= 1e-5."""
    jcfg, _ = _cfgs()
    _, tcfg = _cfgs(remat=True)
    params = _host(JW.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(7)
    frames = _normal(rng, 4, FRAMES, jcfg.d_model)
    toks = rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (4, 16)).astype(np.int32)
    jb, tb = _batches(frames, toks)
    jb["labels"], tb["labels"] = jnp.asarray(labels), torch.from_numpy(labels)
    (lj, _), gj = jax.jit(jax.value_and_grad(
        lambda p: JW.loss_fn(p, jb, jcfg), has_aux=True))(params)
    p = with_grad(from_jax_numpy(params))
    lt, _ = TW.loss_fn(p, tb, tcfg)
    np.testing.assert_allclose(lt.item(), float(lj), **F32)
    for a, b in zip(tree_leaves(to_numpy(grads(lt, p))),
                    jax.tree_util.tree_leaves(_host(gj))):
        np.testing.assert_allclose(a, b, **F32)
    jopt, topt = j_sgd(1e-2, momentum=0.9), sgd_momentum(1e-2, momentum=0.9)
    jp, _ = jopt.update(gj, jopt.init(params), params, 0)
    tp0 = from_jax_numpy(params)
    tp, _, step, tl = make_train_step(get_arch(ARCH), tcfg, topt, sfpl=True)(
        tp0, topt.init(tp0), 0, dict(tb, perm=torch.arange(4)))
    assert step == 1
    np.testing.assert_allclose(float(tl), float(lj), **F32)
    for a, b in zip(tree_leaves(to_numpy(tp)),
                    jax.tree_util.tree_leaves(_host(jp))):
        np.testing.assert_allclose(a, b, **F32)


# --------------------------------------------------------------------------
# the launchers, the full config and conversion

def test_train_lm_and_evaluate_lm_run_whisper(tmp_path, capsys):
    """``launch.train --arch whisper-large-v3`` (smoke, CPU, 16 frames a
    batch) trains to finite losses and checkpoints; ``launch.eval``
    restores the checkpoint, whose loss differs from the untrained
    init's."""
    _check_train_eval(ARCH, tmp_path, capsys)


def test_serve_runs_whisper():
    from repro_torch.launch.serve import serve
    out = serve(ARCH, batch=2, prompt_len=6, gen=5, device="cpu")
    assert tuple(out.shape) == (2, 5)
    assert 0 <= int(out.min()) and int(out.max()) < 512


def test_full_config_param_count():
    """whisper-large-v3's 1.54 B parameters (its 32 + 32 layers at d 1280),
    counted on the meta device, with the JAX package's leaf shapes."""
    spec = get_arch(ARCH)
    with torch.device("meta"):
        params = spec.model.init(None, spec.make_config())
    leaves = tree_leaves(params)
    assert all(t.is_meta for t in leaves)
    n = sum(t.numel() for t in leaves)
    assert abs(n / 1e9 - 1.54) / 1.54 < 0.01, n
    jspec = j_get_arch(ARCH)
    shapes = jax.eval_shape(lambda: jspec.model.init(jax.random.PRNGKey(0),
                                                     jspec.make_config()))
    assert [tuple(t.shape) for t in leaves] == [
        tuple(s.shape) for s in jax.tree_util.tree_leaves(shapes)]


def test_whisper_tree_round_trips_with_jax_structure(smoke):
    """The attention biases and the layer norms carry across, the round
    trip is bit for bit, and the port's own init has the same leaves."""
    params, _, _ = smoke
    tp = from_jax_numpy(params)
    assert tuple(tp["dec_layers"]["cross_attn"]["wq"]["b"].shape) == (2, 128)
    assert "b" not in tp["enc_layers"]["attn"]["wo"]
    for a, b in zip(jax.tree_util.tree_leaves(to_numpy(tp)),
                    jax.tree_util.tree_leaves(params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    _, tcfg = _cfgs()
    port = tree_leaves(TW.init(torch.Generator().manual_seed(0), tcfg))
    assert [(tuple(t.shape), t.dtype) for t in port] == [
        (tuple(t.shape), t.dtype) for t in tree_leaves(tp)]


# --------------------------------------------------------------------------
# the registry's input specs

def _flat(tree, path=()):
    """{path: (shape, dtype name)} of a nest of dicts of arrays."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    dt = (str(tree.dtype).removeprefix("torch.")
          if isinstance(tree, torch.Tensor) else np.dtype(tree.dtype).name)
    return {path: (tuple(tree.shape), dt)}


def test_port_registers_the_jax_packages_archs():
    from repro.configs import list_archs as j_list_archs
    assert list_archs() == j_list_archs()
    assert sorted(SHAPES) == sorted(J_SHAPES)


@pytest.mark.parametrize("arch", sorted(
    ["gemma-7b", "llama4-maverick-400b-a17b", "llama4-scout-17b-a16e",
     "minitron-8b", "phi3-medium-14b", "qwen2-vl-7b", "qwen3-8b",
     "recurrentgemma-9b", "whisper-large-v3", "xlstm-1.3b"]))
def test_input_specs_match_jax(arch):
    """Every input of every shape kind, decode states included, at the
    full config: the JAX package's shapes and dtypes, on the meta device
    (nothing is allocated)."""
    spec, jspec = get_arch(arch), j_get_arch(arch)
    cfg, jcfg = spec.make_config(), jspec.make_config()
    for name, shape in SHAPES.items():
        got = input_specs(spec, cfg, shape)
        want = j_input_specs(jspec, jcfg, J_SHAPES[name])
        assert all(t.is_meta for t in tree_leaves(got))
        assert _flat(got) == _flat(want), (arch, name)
    got = input_specs(spec, cfg, SHAPES["decode_32k"],
                      cache_dtype=torch.float32)
    want = j_input_specs(jspec, jcfg, J_SHAPES["decode_32k"],
                         cache_dtype=jnp.float32)
    assert _flat(got) == _flat(want)
