"""Architecture registry: ``get_config(name)`` / ``--arch <id>``.

Copies of the reference's ``repro.configs`` data files, schema and
dry-run shape cells."""

from __future__ import annotations

from .base import ArchConfig
from .shapes import SHAPES, ShapeCell, applicable, cells_for

from .gemma3_1b import CONFIG as _gemma3_1b
from .gemma2_27b import CONFIG as _gemma2_27b
from .mistral_large_123b import CONFIG as _mistral_large_123b
from .deepseek_7b import CONFIG as _deepseek_7b
from .hubert_xlarge import CONFIG as _hubert_xlarge
from .grok1_314b import CONFIG as _grok1_314b
from .granite_moe_1b import CONFIG as _granite_moe_1b
from .qwen2_vl_72b import CONFIG as _qwen2_vl_72b
from .falcon_mamba_7b import CONFIG as _falcon_mamba_7b
from .recurrentgemma_9b import CONFIG as _recurrentgemma_9b

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (
        _gemma3_1b, _gemma2_27b, _mistral_large_123b, _deepseek_7b,
        _hubert_xlarge, _grok1_314b, _granite_moe_1b, _qwen2_vl_72b,
        _falcon_mamba_7b, _recurrentgemma_9b,
    )
}


def get_config(name: str) -> ArchConfig:
    try:
        return ARCHS[name]
    except KeyError:
        raise ValueError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")


def list_archs() -> list[str]:
    return sorted(ARCHS)


__all__ = ["ArchConfig", "ARCHS", "get_config", "list_archs",
           "SHAPES", "ShapeCell", "applicable", "cells_for"]
