"""Architecture registry: ``--arch <id>`` lookup and per-shape input
specs.

The port registers the JAX package's ten architectures: the dense
transformers qwen3-8b, gemma-7b, minitron-8b and phi3-medium-14b, the MoE
transformers llama4-scout-17b-a16e and llama4-maverick-400b-a17b, the VLM
backbone qwen2-vl-7b, the xLSTM family's xlstm-1.3b, the RG-LRU hybrid
recurrentgemma-9b and the encoder-decoder whisper-large-v3
(``list_archs``). ``get_arch`` also resolves the port's own architectures,
which the JAX package does not have and ``list_archs`` leaves out:
afmoe's trinity-mini.
``input_specs`` returns meta-device stand-ins for a step's inputs (no
storage is allocated).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional

import torch

from repro_torch.configs.shapes import InputShape

_REGISTRY = {}
_OWN = {}
_FAMILIES = {"transformer": "repro_torch.models.transformer",
             "xlstm": "repro_torch.models.xlstm",
             "rglru": "repro_torch.models.rglru",
             "whisper": "repro_torch.models.whisper"}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                      # transformer | xlstm | rglru | whisper
    citation: str
    make_config: Callable            # (**overrides) -> full-size config
    make_smoke_config: Callable      # (**overrides) -> reduced config
    supports_long_context: bool = False
    notes: str = ""

    @property
    def model(self):
        return importlib.import_module(_FAMILIES[self.family])

    def skip_reason(self, shape: InputShape) -> Optional[str]:
        """Why the architecture study skips ``shape``, or None."""
        if shape.name == "long_500k" and not self.supports_long_context:
            return ("pure global-attention architecture: 500k-token decode "
                    "requires a sub-quadratic / windowed variant")
        return None


def register(spec: ArchSpec, *, own=False):
    """Register ``spec``; ``own``: an architecture of the port alone."""
    (_OWN if own else _REGISTRY)[spec.arch_id] = spec
    return spec


_ARCH_MODULES = ["qwen3_8b", "gemma_7b", "minitron_8b", "phi3_medium_14b",
                 "llama4_scout_17b_a16e", "llama4_maverick_400b_a17b",
                 "qwen2_vl_7b", "xlstm_1_3b", "recurrentgemma_9b",
                 "whisper_large_v3"]
_OWN_MODULES = ["trinity_mini"]
_loaded = False


def _ensure_loaded():
    global _loaded
    if not _loaded:
        for m in _ARCH_MODULES + _OWN_MODULES:
            importlib.import_module(f"repro_torch.configs.{m}")
        _loaded = True


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    spec = _REGISTRY.get(arch_id, _OWN.get(arch_id))
    if spec is None:
        raise KeyError(f"unknown arch {arch_id!r}; the port has "
                       f"{sorted(_REGISTRY) + sorted(_OWN)}")
    return spec


def list_archs():
    """The architectures the port shares with the JAX package."""
    _ensure_loaded()
    return sorted(_REGISTRY)


# --------------------------------------------------------------------------
# input specs

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(spec: ArchSpec, cfg, shape: InputShape, *,
                cache_dtype=torch.bfloat16):
    """Meta-device stand-ins for the inputs of the step that ``shape``'s
    kind selects: {tokens[, labels][, vision_embeds]} for train and
    prefill ({frame_embeds, tokens[, labels]} for whisper, whose decoder
    takes at most its 448-token context), {tokens (B, 1), state} for
    decode, the state being the family's ``init_decode_state`` on the
    meta device."""
    B, S = shape.global_batch, shape.seq_len
    fam = spec.family
    if shape.kind in ("train", "prefill"):
        if fam == "whisper":
            # seq_len is the encoder's frames (stub frontend embeddings)
            st = min(448, S)
            specs = {"frame_embeds": _meta((B, S, cfg.d_model),
                                           torch.bfloat16),
                     "tokens": _meta((B, st), torch.int32)}
            if shape.kind == "train":
                specs["labels"] = _meta((B, st), torch.int32)
            return specs
        specs = {"tokens": _meta((B, S), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = _meta((B, S), torch.int32)
        if fam == "transformer" and getattr(cfg, "vision_tokens", 0):
            specs["vision_embeds"] = _meta((B, cfg.vision_tokens,
                                            cfg.d_model), torch.bfloat16)
        return specs
    # decode: one new token and the carried state of seq_len positions
    kw = dict(dtype=cache_dtype, device="meta")
    if fam == "whisper":
        kw["enc_frames"] = cfg.max_source_positions
    state = spec.model.init_decode_state(cfg, B, S, **kw)
    return {"tokens": _meta((B, 1), torch.int32), "state": state}
