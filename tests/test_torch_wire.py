"""The port's wire format (``repro_torch.core.wire``) against the JAX
package's (``repro.core.wire``), bitwise.

Inputs are made with numpy from a seed; bf16 inputs are rounded to bf16
identically on both sides. Rows cover the hazards: all-zero rows (scale
0, exact zeros back), rows whose amax is a negative entry, rows whose
scaled values land on .5 ties (round half to even), and magnitudes
spread over many binades (fp8 subnormals). Every quantized byte, scale
bit and dequantized value must match exactly; so must the packed scale
lanes and the golden wire bytes of ``tests/test_route_plan.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as JW
from repro.core import collector_dist as JCD
from repro_torch.core import collector_dist as TCD
from repro_torch.core import wire as TW

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rows(seed, d=37):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((24, d)) * 3).astype(np.float32)
    x[0] = 0.0                                        # all-zero row
    x[1] = -np.abs(x[1])                              # amax from a negative
    x[1, 3] = -11.0
    x[2] = np.linspace(-127.0, 127.0, d)              # int8 ties at amax 127
    x[2, ::3] += 0.5
    x[3] = np.arange(d) - d // 2                      # integers: exact grid
    x[3, 0] = 2.0 * (d // 2)                          # amax = 2 * max: .5 ties
    x[4] = 10.0 ** rng.uniform(-8, 2, d)              # many binades
    x[5, :] = 1e-30                                   # tiny amax
    return x


def _pair(a, dtype):
    jd, td = DT[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _bytes_j(a):
    return np.asarray(a).view(np.uint8)


def _bytes_t(t):
    return t.contiguous().view(torch.uint8).numpy()


@pytest.mark.parametrize("wire", ["int8", "float8_e4m3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_dequantize_bitwise(wire, dtype, seed):
    xj, xt = _pair(_rows(seed, d=37 + seed * 90), dtype)
    qj, sj = JW.quantize_rows(xj, wire)
    qt, st = TW.quantize_rows(xt, wire)
    assert qt.dtype == TW.WIRE_DTYPES[wire] and st.dtype == torch.float32
    np.testing.assert_array_equal(_bytes_t(qt), _bytes_j(qj))
    np.testing.assert_array_equal(_bytes_t(st), _bytes_j(sj))
    assert float(st[0]) == 0.0 and not qt[0].float().any()
    jd, td = DT[dtype]
    dj = JW.dequantize_rows(qj, sj, jd)
    dt = TW.dequantize_rows(qt, st, td)
    assert dt.dtype == td
    np.testing.assert_array_equal(_bytes_t(dt.float()),
                                  _bytes_j(dj.astype(jnp.float32)))
    assert not dt[0].float().any()


@pytest.mark.parametrize("wire", ["int8", "float8_e4m3"])
def test_pack_unpack_scales_bitwise(wire):
    rng = np.random.default_rng(3)
    s = np.concatenate([[0.0, 1.0 / 127, 3.5e-38, 1e30],
                        rng.uniform(0, 5, 12)]).astype(np.float32)
    lj = JW.pack_scales(jnp.asarray(s), wire)
    lt = TW.pack_scales(torch.from_numpy(s), wire)
    assert tuple(lt.shape) == (16, TW.SCALE_LANES)
    assert lt.dtype == TW.WIRE_DTYPES[wire]
    np.testing.assert_array_equal(_bytes_t(lt), _bytes_j(lj))
    np.testing.assert_array_equal(TW.unpack_scales(lt).numpy(), s)
    # a zero pad row unpacks to scale 0
    zero = torch.zeros(1, TW.SCALE_LANES, dtype=TW.WIRE_DTYPES[wire])
    assert float(TW.unpack_scales(zero)[0]) == 0.0


def test_tables_and_names_match_jax():
    assert TW.WIRE_DTYPE_NAMES == JW.WIRE_DTYPE_NAMES
    assert TW.QMAX == JW.QMAX
    assert (TW.SCALE_LANES, TW.SCALE_BYTES) == (JW.SCALE_LANES,
                                                JW.SCALE_BYTES)
    for name in TW.WIRE_DTYPE_NAMES:
        assert TW.wire_itemsize(name) == JW.wire_itemsize(name)
        assert TW.is_quantized(name) == JW.is_quantized(name)
        assert TW.resolve_wire_dtype(name) == JW.resolve_wire_dtype(name)
    assert TW.resolve_wire_dtype(None) is None
    with pytest.raises(ValueError, match="unknown wire_dtype 'fp4'"):
        TW.resolve_wire_dtype("fp4")
    for wire, qmax in TW.QMAX.items():
        assert TW.scale_multiplier(wire) == float(np.float32(1.0 / qmax))


def test_plan_payload_bytes_golden():
    """131072 / 65536 / 33024 bytes at D = 512 over the balanced 64-row,
    8-shard plan (tests/test_route_plan.py), and the same bytes as the
    JAX package's accounting for the same plan."""
    n, s, d = 64, 8, 512
    perm = TCD.make_balanced_perm(torch.Generator().manual_seed(0), n, s)
    plan, _ = TCD.build_route_plans(perm, s, cap=TCD.exact_pair_cap(n, s),
                                    may_drop=False)
    golden = {None: 131072, "float32": 131072, "bfloat16": 65536,
              "int8": 33024, "float8_e4m3": 33024}
    jplan, _ = JCD.build_route_plans(jnp.asarray(perm.numpy()), s,
                                     cap=JCD.exact_pair_cap(n, s),
                                     may_drop=False)
    for wire, want in golden.items():
        assert TCD.plan_payload_bytes(plan, d, 4, wire_dtype=wire) == want
        assert JCD.plan_payload_bytes(jplan, d, 4, wire_dtype=wire) == want
    assert TCD.plan_payload_bytes(plan, 16, 4, wire_dtype="int8") == 64 * 20
