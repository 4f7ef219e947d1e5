"""Wire formats for the smashed-data exchange.

The collector's cost on constrained links is wire bytes: ``wire_dtype``
lets the smashed rows (and, behind ``wire_dtype_bwd``, the routed-back
gradient rows) cross each collective in a narrower dtype than they are
computed in, independently of the f32 master-param training contract.

  * ``"float32"``     the identity wire (ship as computed);
  * ``"bfloat16"``    cast only, half the f32 bytes, no sidecar;
  * ``"int8"``        per-row symmetric amax quantization (qmax 127);
  * ``"float8_e4m3"`` per-row amax scaling into the e4m3 grid (qmax 448).

Quantized wires carry one f32 scale per row, bitcast by
:func:`pack_scales` into ``SCALE_LANES`` one-byte lanes appended as extra
feature columns of the one payload operand, so the exchange stays one
``all_to_all`` per direction. A zero payload row (the slack pad row)
unpacks to scale 0 and dequantizes to exact zeros.

The arithmetic is the JAX package's bit for bit: the scale is
``amax * f32(1/qmax)`` (the reciprocal is Python's double rounded to f32),
the inverse ``qmax / amax`` is an IEEE f32 division (written
``torch.full_like(amax, qmax) / amax``: ``qmax / tensor`` in PyTorch is a
reciprocal times ``qmax``, which rounds differently), ``torch.round``
rounds half to even like ``jnp.round``, and the cast to
``float8_e4m3fn`` rounds to nearest even.

>>> x = torch.tensor([[1.0, -2.0, 0.5], [0.0, 0.0, 0.0]])
>>> q, s = quantize_rows(x, "int8")
>>> (q.dtype, s.dtype, tuple(s.shape), int(q[0, 1]), float(s[1]))
(torch.int8, torch.float32, (2,), -127, 0.0)
>>> bool((unpack_scales(pack_scales(s, "int8")) == s).all())
True
>>> resolve_wire_dtype(None), resolve_wire_dtype("float32")
(None, None)
"""
from __future__ import annotations

import struct

import torch

WIRE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "float8_e4m3": torch.float8_e4m3fn,
}

WIRE_DTYPE_NAMES = tuple(WIRE_DTYPES)

# largest exactly-representable magnitude of each quantized wire grid
QMAX = {"int8": 127.0, "float8_e4m3": 448.0}

# one f32 row scale bitcast into this many one-byte wire lanes
SCALE_LANES = 4
SCALE_BYTES = 4


def resolve_wire_dtype(name):
    """Canonical wire-dtype name, or ``None`` for the identity wire
    (``None`` / ``"float32"``). Unknown names raise with the supported
    set, so a launcher typo fails before any device work."""
    if name is None or name == "float32":
        return None
    if name not in WIRE_DTYPES:
        raise ValueError(f"unknown wire_dtype {name!r}: expected one of "
                         f"{WIRE_DTYPE_NAMES}")
    return name


def is_quantized(name):
    """True for wire dtypes that need per-row scales (int8 / fp8)."""
    return name in QMAX


def wire_itemsize(name):
    """Bytes per element on the wire (1 for int8/fp8, 2 for bf16)."""
    return WIRE_DTYPES[name].itemsize


def scale_multiplier(wire_dtype):
    """``1/qmax`` as f32: Python's double quotient rounded once to f32."""
    return struct.unpack("<f", struct.pack("<f", 1.0 / QMAX[wire_dtype]))[0]


def quantize_rows(x, wire_dtype):
    """Per-row symmetric quantization of ``(R, D)`` float rows. Returns
    ``(q, scales)``: ``q`` in the wire dtype and f32 ``scales`` (R,) with
    ``x ~= q * scales[:, None]``; all-zero rows get scale 0 and quantize
    to zeros. The ``quant_permute`` kernel reproduces this bit for bit."""
    qmax = QMAX[wire_dtype]
    xf = x.float()
    amax = xf.abs().amax(dim=1)
    # an f32-exact Python scalar: the multiply is one f32 rounding, and no
    # host tensor is copied to the device (CUDA graphs allow none)
    scale = amax * scale_multiplier(wire_dtype)
    pos = amax > 0
    inv = torch.where(pos, torch.full_like(amax, qmax)
                      / torch.where(pos, amax, torch.ones_like(amax)),
                      torch.zeros_like(amax))
    y = xf * inv[:, None]
    if not WIRE_DTYPES[wire_dtype].is_floating_point:
        y = torch.round(y)
    return y.to(WIRE_DTYPES[wire_dtype]), scale


def dequantize_rows(q, scales, out_dtype):
    """Inverse of :func:`quantize_rows`: ``(R, D)`` wire rows times their
    f32 row scales, cast to ``out_dtype``."""
    return (q.float() * scales[:, None]).to(out_dtype)


def pack_scales(scales, wire_dtype):
    """Bitcast ``(R,)`` f32 scales into ``(R, SCALE_LANES)`` one-byte
    lanes of the wire dtype (little-endian byte order, as the JAX
    package's ``bitcast_convert_type``)."""
    r = scales.shape[0]
    return scales.contiguous().view(torch.uint8).view(
        WIRE_DTYPES[wire_dtype]).reshape(r, SCALE_LANES)


def unpack_scales(lanes):
    """Inverse of :func:`pack_scales`: ``(R, SCALE_LANES)`` one-byte lanes
    back to ``(R,)`` f32 scales."""
    r = lanes.shape[0]
    return lanes.contiguous().view(torch.uint8).view(torch.float32).reshape(r)
