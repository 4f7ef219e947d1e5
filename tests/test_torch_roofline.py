"""The port's roofline (``repro_torch.roofline``) against the JAX
package's: the layer units, the closed-form attention FLOPs and the
active parameter counts of all ten architectures, the roofline terms of
one pair of dry-run results, and the 1-unit / 2-unit extrapolation
against a full-depth trace (on ``cpu`` meshes over a ``fake`` group that
each dry run starts and tears down)."""
import pytest
import torch

from repro.configs import SHAPES as J_SHAPES, get_arch as j_get_arch
from repro.roofline import analysis as JA
from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun as DR
from repro_torch.nn import attention as A
from repro_torch.roofline import analysis as TA
from repro_torch.roofline import run as TR
from test_torch_lm_train import _one_thread  # noqa: F401
from test_torch_dryrun import _no_group, smoke  # noqa: F401

ARCHS = ["qwen3-8b", "gemma-7b", "minitron-8b", "phi3-medium-14b",
         "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
         "qwen2-vl-7b", "xlstm-1.3b", "recurrentgemma-9b",
         "whisper-large-v3"]


@pytest.mark.parametrize("arch", ARCHS)
def test_units_attention_and_active_params_match_jax(arch):
    assert arch in list_archs()
    spec, jspec = get_arch(arch), j_get_arch(arch)
    cfg, jcfg = spec.make_config(), jspec.make_config()
    got, want = TA._family_units(spec, cfg), JA._family_units(jspec, jcfg)
    assert got[0] == want[0]
    # the port has no scan_layers: the same depth overrides
    assert got[1:] == tuple({k: v for k, v in d.items()} for d in want[1:])
    for name in SHAPES:
        assert TA.attention_flops_global(spec, cfg, SHAPES[name]) == \
            JA.attention_flops_global(jspec, jcfg, J_SHAPES[name]), name
    assert TA.active_params(spec, cfg) == JA.active_params(jspec, jcfg)


def _result(flops, bytes_, coll):
    return {"cost": {"flops": flops, "bytes_accessed": bytes_},
            "collectives": {op: {"count": 1, "bytes": b,
                                 "traffic_bytes": b}
                            for op, b in coll.items()}}


@pytest.mark.parametrize("name", ["train_4k", "decode_32k"])
def test_roofline_terms_match_jax(name):
    """One pair of result dicts through both: the counts agree, and the
    time terms are JAX's times the ratio of the two hardware tables."""
    arch = "llama4-scout-17b-a16e"
    spec, jspec = get_arch(arch), j_get_arch(arch)
    cfg, jcfg = spec.make_config(), jspec.make_config()
    r1 = _result(3.0e13, 2.0e11, {"all-gather": 4e9, "all-reduce": 1e9})
    r2 = _result(5.5e13, 3.5e11, {"all-gather": 7e9, "reduce-scatter": 2e9})
    n = TA._family_units(spec, cfg)[0]
    got = TA.roofline_terms(r1, r2, n, devices=256, shape=SHAPES[name],
                            spec=spec, cfg=cfg)
    want = JA.roofline_terms(r1, r2, n, devices=256, shape=J_SHAPES[name],
                             spec=jspec, cfg=jcfg)
    assert set(got) == set(want)
    for k in ("flops_per_dev", "bytes_per_dev", "coll_bytes_per_dev",
              "coll_breakdown", "model_flops_global", "hlo_flops_global",
              "useful_ratio", "attn_flops_correction"):
        assert got[k] == want[k], k
    for k, hw in (("compute_s", "peak_flops"), ("memory_s", "hbm_bw"),
                  ("collective_s", None)):
        ratio = (JA.HW[hw] / TA.HW[hw]) if hw else \
            JA.HW["ici_bw"] / TA.HW["net_bw"]
        assert got[k] == pytest.approx(want[k] * ratio, rel=1e-12), k
    assert TA.RECOMMENDATIONS.keys() == JA.RECOMMENDATIONS.keys()


def test_no_kv_chunk_correction():
    """The JAX package adds back the kv-chunk scan that its cost analysis
    counts once (prefill past 8,192 tokens). The port's attention loops
    over the chunks in Python, so a trace counts every chunk: one chunk
    or eight give the same FLOPs, and the correction is 0.0 on every
    shape."""
    q = torch.zeros(1, 64, 4, 8)
    k = v = torch.zeros(1, 64, 2, 8)
    pos = torch.arange(64)[None]
    counts = []
    for chunk in (64, 8):
        tracer = DR.StepTracer()
        with tracer:
            A._xla_attention(q, k, v, 0.35, q_pos=pos, kv_pos=pos,
                             kv_chunk=chunk)
        counts.append(tracer.flops)
    assert counts[0] == counts[1] > 0
    spec = get_arch("qwen3-8b")
    cfg = spec.make_config()
    r = _result(1e12, 1e9, {})
    for shape in SHAPES.values():
        assert TA.roofline_terms(r, r, 36, devices=256, shape=shape,
                                 spec=spec, cfg=cfg)[
            "attn_flops_correction"] == 0.0


def test_unit_extrapolation_equals_a_full_depth_trace():
    """Eager torch counts every layer: 1 and 2 layer units extrapolated
    to 4 give the 4-layer trace's FLOPs and collectives exactly (a smoke
    qwen3-8b train step on the 16x16 fake mesh)."""
    shape = InputShape("t", 64, 32, "train")
    base = smoke("qwen3-8b")
    r = {n: DR.lower_one("qwen3-8b", shape, device="cpu",
                         cfg_overrides=dict(base, num_layers=n))
         for n in (1, 2, 4)}
    spec = get_arch("qwen3-8b")
    cfg = spec.make_config(**dict(base, num_layers=4))
    units, ov1, ov2 = TA._family_units(spec, cfg)
    assert (units, ov1, ov2) == (4, {"num_layers": 1}, {"num_layers": 2})
    terms = TA.roofline_terms(r[1], r[2], units, devices=256, shape=shape,
                              spec=spec, cfg=cfg)
    assert terms["flops_per_dev"] == r[4]["cost"]["flops"]
    assert terms["coll_bytes_per_dev"] == sum(
        d["traffic_bytes"] for d in r[4]["collectives"].values())
    # bytes: each layer's gradient of its slice of the stacked leaves
    # (select's backward) writes a zero tensor the size of the whole
    # stack, a term that grows with the depth squared, which a linear
    # extrapolation leaves out: 0.2 % here
    assert terms["bytes_per_dev"] == pytest.approx(
        r[4]["cost"]["bytes_accessed"], rel=5e-3)
    assert terms["bytes_per_dev"] < r[4]["cost"]["bytes_accessed"]


def test_row_md_of_a_pair():
    """``roofline_pair`` and ``row_md`` at a smoke config's scale."""
    row = TR.row_md(TR.roofline_pair("xlstm-1.3b", "decode_32k",
                                     cfg_overrides=smoke("xlstm-1.3b"),
                                     device="cpu"))
    assert row.startswith("| xlstm-1.3b | decode_32k |")
    assert row.count("|") == 9
    assert TR.row_md(TR.roofline_pair("qwen3-8b", "long_500k")).count(
        "skipped") == 1
