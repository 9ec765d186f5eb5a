"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

The ids and aliases are ``repro.configs``'s, and every id's config is a
copy of the reference's with its exact public-literature dimensions: the
dense decoders, RWKV6, the MoE decoders (OLMoE-1B-7B, Qwen3-MoE-235B),
the RG-LRU hybrid (RecurrentGemma-2B), the encoder-decoder (Whisper-small)
and the VLM backbone (InternVL2-26B).
"""
from __future__ import annotations

import importlib

from .base import INPUT_SHAPES, ArchConfig, InputShape, reduced

ARCH_IDS = [
    "internvl2_26b",
    "rwkv6_1b6",
    "command_r_35b",
    "recurrentgemma_2b",
    "qwen3_8b",
    "whisper_small",
    "olmoe_1b_7b",
    "qwen3_moe_235b_a22b",
    "llama3_405b",
    "minitron_4b",
    "paper_sim",
]

_ALIASES = {
    "internvl2-26b": "internvl2_26b",
    "rwkv6-1.6b": "rwkv6_1b6",
    "command-r-35b": "command_r_35b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen3-8b": "qwen3_8b",
    "whisper-small": "whisper_small",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama3-405b": "llama3_405b",
    "minitron-4b": "minitron_4b",
}


def get_config(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "reduced",
           "get_config", "ARCH_IDS"]
