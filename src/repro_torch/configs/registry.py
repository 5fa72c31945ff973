"""Architecture and shape registry: the 10 assigned (arch × shape) grids,
as the reference's ``repro/configs/registry.py``, with every arch's
config.

Shapes (LM family):
  train_4k     seq 4,096   global_batch 256   → train_step
  prefill_32k  seq 32,768  global_batch 32    → prefill
  decode_32k   seq 32,768  global_batch 128   → serve_step (1 new token)
  long_500k    seq 524,288 global_batch 1     → serve_step; sub-quadratic
                                                archs only (see DESIGN.md)
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.models.common import ArchConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

ARCHS = [
    "seamless_m4t_medium",
    "olmoe_1b_7b",
    "qwen2_moe_a2_7b",
    "qwen1_5_110b",
    "nemotron_4_340b",
    "gemma2_2b",
    "stablelm_3b",
    "llava_next_mistral_7b",
    "jamba_1_5_large_398b",
    "xlstm_125m",
]

# accept dashed ids from the assignment table too
_ALIASES = {a.replace("_", "-"): a for a in ARCHS}
_ALIASES.update({
    "seamless-m4t-medium": "seamless_m4t_medium",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen1.5-110b": "qwen1_5_110b",
    "nemotron-4-340b": "nemotron_4_340b",
    "gemma2-2b": "gemma2_2b",
    "stablelm-3b": "stablelm_3b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "xlstm-125m": "xlstm_125m",
})


def canon(arch: str) -> str:
    return _ALIASES.get(arch, arch)


def _module(arch: str):
    return importlib.import_module(f"repro_torch.configs.{canon(arch)}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).smoke_config()


def shape_spec(name: str) -> ShapeSpec:
    return SHAPES[name]


def cell_is_skipped(cfg: ArchConfig, shape: str) -> Optional[str]:
    """Reason string if this (arch, shape) cell is skipped, else None."""
    return cfg.skip_shapes.get(shape)
