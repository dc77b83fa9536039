"""Assigned architecture registry: ``get_config("--arch id")`` per cell.

Each assigned architecture lives in its own module with the exact published
configuration; ``REGISTRY`` maps the public ``--arch`` ids to them.
"""
from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K,
                                ModelConfig, PREFILL_32K, ShapeConfig,
                                TRAIN_4K, smoke)

from repro_torch.configs.zamba2_2p7b import CONFIG as zamba2_2p7b
from repro_torch.configs.gemma3_4b import CONFIG as gemma3_4b
from repro_torch.configs.yi_6b import CONFIG as yi_6b
from repro_torch.configs.nemotron_4_15b import CONFIG as nemotron_4_15b
from repro_torch.configs.qwen3_1p7b import CONFIG as qwen3_1p7b
from repro_torch.configs.falcon_mamba_7b import CONFIG as falcon_mamba_7b
from repro_torch.configs.whisper_medium import CONFIG as whisper_medium
from repro_torch.configs.llava_next_mistral_7b import CONFIG as llava_next_mistral_7b
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as llama4_scout_17b_a16e
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as granite_moe_3b_a800m

REGISTRY = {
    "zamba2-2.7b": zamba2_2p7b,
    "gemma3-4b": gemma3_4b,
    "yi-6b": yi_6b,
    "nemotron-4-15b": nemotron_4_15b,
    "qwen3-1.7b": qwen3_1p7b,
    "falcon-mamba-7b": falcon_mamba_7b,
    "whisper-medium": whisper_medium,
    "llava-next-mistral-7b": llava_next_mistral_7b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
}

SHAPES = {s.name: s for s in ALL_SHAPES}

#: archs with sub-quadratic sequence handling run the long_500k cell;
#: pure full-attention archs skip it (documented in DESIGN.md §6).
SUBQUADRATIC = {"zamba2-2.7b", "falcon-mamba-7b"}


def get_config(arch: str) -> ModelConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; choose from "
                       f"{sorted(REGISTRY)}") from None


def cells():
    """All runnable (arch, shape) dry-run cells."""
    out = []
    for arch in REGISTRY:
        for shape in ALL_SHAPES:
            if shape.name == "long_500k" and arch not in SUBQUADRATIC:
                continue
            out.append((arch, shape.name))
    return out


__all__ = ["REGISTRY", "SHAPES", "SUBQUADRATIC", "ModelConfig",
           "ShapeConfig", "get_config", "cells", "smoke",
           "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
           "ALL_SHAPES"]
