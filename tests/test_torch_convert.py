"""numpy (JAX layout) -> torch -> numpy is bitwise for the engine's trees
and the transformer's, and the port's own trees have the JAX trees' keys
and shapes."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.core import engine as JE
from repro.models import resnet as JR
from repro.optim import sgd_momentum as j_sgd
from repro_torch.configs import get_arch
from repro_torch.convert import from_jax_numpy, to_numpy
from repro_torch.core import engine as TE
from repro_torch.models import resnet as TR
from repro_torch.models.common import TransformerConfig
from repro_torch.optim import sgd_momentum as t_sgd


@pytest.fixture(scope="module")
def trees():
    cfg = JR.ResNetConfig(depth=8, num_classes=4, width=8)
    opt = j_sgd(0.05, momentum=0.9)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: JR.init(k, cfg))(jax.random.PRNGKey(1)))
    return {
        "init": {"params": params[0], "state": params[1]},
        "dcml": JE.init_dcml_state(None, lambda k: params, 3, opt, opt),
        "fl": JE.init_fl_state(None, lambda k: params, 3, opt),
    }


def _leaves_with_paths(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


@pytest.mark.parametrize("name", ["init", "dcml", "fl"])
def test_round_trip_is_bitwise(trees, name):
    tree = jax.tree_util.tree_map(np.asarray, trees[name])
    back = to_numpy(from_jax_numpy(tree))
    a, b = _leaves_with_paths(tree), _leaves_with_paths(back)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, u), (_, v) in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape, path
        assert u.tobytes() == v.tobytes(), path


def test_conv_kernels_become_oihw(trees):
    t = from_jax_numpy(jax.tree_util.tree_map(np.asarray, trees["dcml"]))
    hwio = np.asarray(trees["dcml"]["cp"]["conv1"]["w"])     # (N, 3, 3, 3, 8)
    w = t["cp"]["conv1"]["w"]
    assert tuple(w.shape) == (hwio.shape[0], 8, 3, 3, 3)
    np.testing.assert_array_equal(w[1, 5, 2, 0, 1].item(), hwio[1, 0, 1, 2, 5])
    assert tuple(t["copt"]["mu"]["conv1"]["w"].shape) == tuple(w.shape)
    assert tuple(t["sp"]["fc"]["w"].shape) == (32, 4)          # dense kept


def test_port_init_has_jax_tree_structure(trees):
    cfg = TR.ResNetConfig(depth=8, num_classes=4, width=8)
    opt = t_sgd(0.05, momentum=0.9)
    st = TE.init_dcml_state(torch.Generator().manual_seed(0),
                            lambda g: TR.init(g, cfg), 3, opt, opt)
    ours = _leaves_with_paths(to_numpy(st))
    theirs = _leaves_with_paths(jax.tree_util.tree_map(np.asarray,
                                                       trees["dcml"]))
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, u), (_, v) in zip(ours, theirs):
        assert u.shape == v.shape and u.dtype == v.dtype, path


@pytest.fixture(scope="module")
def lm_params():
    """qwen3-8b's smoke config: per-group params stacked on a leading
    num_groups axis, so every dense ``w`` leaf of a layer has 3 dims."""
    spec = j_get_arch("qwen3-8b")
    cfg = spec.make_smoke_config()
    return cfg, jax.tree_util.tree_map(
        np.asarray, spec.model.init(jax.random.PRNGKey(2), cfg))


def test_transformer_tree_round_trips_bitwise(lm_params):
    _, tree = lm_params
    back = to_numpy(from_jax_numpy(tree))
    a, b = _leaves_with_paths(tree), _leaves_with_paths(back)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, u), (_, v) in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape, path
        assert u.tobytes() == v.tobytes(), path


def test_stacked_dense_weights_are_not_conv_kernels(lm_params):
    """The conv rule (a 4- or 5-dim ``w``) leaves the transformer's 3-dim
    stacked dense weights as they are: same shape, same values."""
    cfg, tree = lm_params
    t = from_jax_numpy(tree)
    wq = tree["layers"]["sub0"]["attn"]["wq"]["w"]
    assert wq.shape == (cfg.num_layers, cfg.d_model,
                        cfg.num_heads * cfg.head_dim)
    for name in ("wq", "wk", "wv", "wo"):
        w = tree["layers"]["sub0"]["attn"][name]["w"]
        assert w.ndim == 3
        np.testing.assert_array_equal(
            t["layers"]["sub0"]["attn"][name]["w"].numpy(), w)
    np.testing.assert_array_equal(t["layers"]["sub0"]["mlp"]["wi"]["w"]
                                  .numpy(), tree["layers"]["sub0"]["mlp"]
                                  ["wi"]["w"])


def test_port_transformer_init_has_jax_tree_structure(lm_params):
    cfg, tree = lm_params
    tcfg = TransformerConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(cfg)})
    ours = _leaves_with_paths(to_numpy(get_arch("qwen3-8b").model.init(
        torch.Generator().manual_seed(0), tcfg)))
    theirs = _leaves_with_paths(tree)
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, u), (_, v) in zip(ours, theirs):
        assert u.shape == v.shape and u.dtype == v.dtype, path


@pytest.mark.parametrize("arch,vocab", [("gemma-7b", 256000),
                                        ("minitron-8b", 512),
                                        ("phi3-medium-14b", 512)])
def test_dense_arch_tree_round_trips_with_jax_structure(arch, vocab):
    """The other dense archs' smoke trees (gemma-7b's at its full 256,000
    vocab: the tied table is the only vocab-sized leaf, no ``unembed``):
    the round trip is bitwise, and the port's own init has the JAX tree's
    keys, shapes and dtypes."""
    jspec = j_get_arch(arch)
    cfg = dataclasses.replace(jspec.make_smoke_config(), vocab_size=vocab)
    tree = jax.tree_util.tree_map(
        np.asarray, jspec.model.init(jax.random.PRNGKey(4), cfg))
    assert ("unembed" in tree) == (not cfg.tie_embeddings)
    assert tree["embed"]["table"].shape == (vocab, cfg.d_model)
    a = _leaves_with_paths(tree)
    b = _leaves_with_paths(to_numpy(from_jax_numpy(tree)))
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, u), (_, v) in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape, path
        assert u.tobytes() == v.tobytes(), path
    tcfg = TransformerConfig(**{f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(cfg)})
    ours = _leaves_with_paths(to_numpy(get_arch(arch).model.init(
        torch.Generator().manual_seed(0), tcfg)))
    assert [p for p, _ in ours] == [p for p, _ in a]
    for (path, u), (_, v) in zip(ours, a):
        assert u.shape == v.shape and u.dtype == v.dtype, path


def test_xlstm_tree_round_trips_bitwise_with_jax_shapes():
    """xlstm-1.3b's smoke tree: the block-diagonal ``wq`` / ``wk`` / ``wv``
    leaves are 4-dim ``w`` leaves but no conv kernels; every leaf keeps its
    JAX shape, and the round trip is bitwise."""
    spec = j_get_arch("xlstm-1.3b")
    cfg = spec.make_smoke_config()
    tree = jax.tree_util.tree_map(
        np.asarray, spec.model.init(jax.random.PRNGKey(3), cfg))
    assert tree["layers"]["sub0"]["wq"]["w"].ndim == 4
    t = from_jax_numpy(tree)
    for (path, u), (_, v) in zip(_leaves_with_paths(tree),
                                 _leaves_with_paths(to_numpy(t))):
        assert u.dtype == v.dtype and u.shape == v.shape, path
        assert u.tobytes() == v.tobytes(), path
    for name in ("wq", "wk", "wv"):
        w = tree["layers"]["sub0"][name]["w"]
        np.testing.assert_array_equal(
            t["layers"]["sub0"][name]["w"].numpy(), w)
