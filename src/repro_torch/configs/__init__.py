"""Architecture registry: the 10 assigned architectures + the paper model.

Every entry carries the exact published configuration from the assignment
block (sources: hf / arXiv ids recorded beside each config).  Select with
``--arch <id>`` in the launchers or ``get_config(id)`` here.
"""
from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from .granite_3_2b import CONFIG as GRANITE_3_2B
from .qwen1_5_0_5b import CONFIG as QWEN15_05B
from .phi3_medium_14b import CONFIG as PHI3_MEDIUM_14B
from .gemma_7b import CONFIG as GEMMA_7B
from .phi3_5_moe_42b import CONFIG as PHI35_MOE_42B
from .llama4_scout_17b import CONFIG as LLAMA4_SCOUT_17B
from .whisper_base import CONFIG as WHISPER_BASE
from .hymba_1_5b import CONFIG as HYMBA_15B
from .mamba2_130m import CONFIG as MAMBA2_130M
from .internvl2_1b import CONFIG as INTERNVL2_1B
from .paper_gpt import CONFIG as PAPER_GPT

ARCHITECTURES: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        GRANITE_3_2B,
        QWEN15_05B,
        PHI3_MEDIUM_14B,
        GEMMA_7B,
        PHI35_MOE_42B,
        LLAMA4_SCOUT_17B,
        WHISPER_BASE,
        HYMBA_15B,
        MAMBA2_130M,
        INTERNVL2_1B,
        PAPER_GPT,
    )
}

ASSIGNED = tuple(n for n in ARCHITECTURES if n != "paper-gpt-125m")


def get_config(name: str) -> ModelConfig:
    try:
        return ARCHITECTURES[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHITECTURES)}"
        ) from None


__all__ = [
    "ARCHITECTURES",
    "ASSIGNED",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "get_config",
    "shape_applicable",
]
