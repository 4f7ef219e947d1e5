"""Architecture registry: ``--arch <id>`` lookup.

The port registers the dense transformers qwen3-8b, gemma-7b,
minitron-8b and phi3-medium-14b, the MoE transformers
llama4-scout-17b-a16e and llama4-maverick-400b-a17b, the VLM backbone
qwen2-vl-7b, and the xLSTM family's xlstm-1.3b; the other architectures
of the JAX package (recurrentgemma-9b, whisper), and ``input_specs`` (its
dry-run shape stand-ins), come with later slices.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable

_REGISTRY = {}
_FAMILIES = {"transformer": "repro_torch.models.transformer",
             "xlstm": "repro_torch.models.xlstm"}


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
        if self.family not in _FAMILIES:
            raise NotImplementedError(
                f"the {self.family} family is not ported yet (ROADMAP "
                f"section 1, 'The other model families')")
        return importlib.import_module(_FAMILIES[self.family])


def register(spec: ArchSpec):
    _REGISTRY[spec.arch_id] = spec
    return spec


_ARCH_MODULES = ["qwen3_8b", "gemma_7b", "minitron_8b", "phi3_medium_14b",
                 "llama4_scout_17b_a16e", "llama4_maverick_400b_a17b",
                 "qwen2_vl_7b", "xlstm_1_3b"]
_loaded = False


def _ensure_loaded():
    global _loaded
    if not _loaded:
        for m in _ARCH_MODULES:
            importlib.import_module(f"repro_torch.configs.{m}")
        _loaded = True


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown or not yet ported arch {arch_id!r} (the "
                       f"rglru and whisper configs come with ROADMAP "
                       f"section 1's next items); the port has "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)
