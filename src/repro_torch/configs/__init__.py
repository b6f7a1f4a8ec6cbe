"""Assigned architecture configs (exact published sizes) + reduced smoke
variants + the four assigned input-shape cells.

``get_config(arch)`` returns the full config; ``get_smoke_config(arch)``
returns a structurally identical reduced config for CPU tests.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.models.config import ModelConfig

ARCHS: Tuple[str, ...] = (
    "granite_20b",
    "nemotron_4_340b",
    "qwen15_110b",
    "qwen3_4b",
    "deepseek_v2_236b",
    "mixtral_8x22b",
    "llama32_vision_90b",
    "xlstm_1_3b",
    "zamba2_2_7b",
    "seamless_m4t_medium",
)

# public --arch ids (hyphenated, as assigned) → module names
ALIASES: Dict[str, str] = {
    "granite-20b": "granite_20b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen1.5-110b": "qwen15_110b",
    "qwen3-4b": "qwen3_4b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mixtral-8x22b": "mixtral_8x22b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "xlstm-1.3b": "xlstm_1_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


@dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)


def shape_cell(name: str) -> ShapeCell:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def _module(arch: str):
    key = ALIASES.get(arch, arch)
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def cell_supported(cfg: ModelConfig, cell: ShapeCell) -> Optional[str]:
    """None if the (arch × shape) cell runs; else the documented skip reason."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return "SKIP(long-context: full attention)"
    return None


def all_cells() -> List[Tuple[str, ShapeCell]]:
    return [(a, s) for a in ARCHS for s in SHAPES]
