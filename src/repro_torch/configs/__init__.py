"""Architecture registry of the port: ``get_config(name)`` / ``--arch <id>``.

The ids and aliases are ``repro.configs``'s. The port runs the dense
decoder family (attention or sliding-window attention mixers, a dense MLP)
and RWKV6 (the ``wkv6`` mixer with the ``rwkv_cm`` channel mix), so only
those configs are copied here, each with the reference's exact
public-literature dimensions. The other families raise
``NotImplementedError`` naming the ROADMAP item that ports them.
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

# archs whose mixer or FFN kind the port does not run yet -> (kind, item)
_NOT_PORTED = {
    "olmoe_1b_7b": ("the moe FFN", "ROADMAP queue 1 item 9d"),
    "qwen3_moe_235b_a22b": ("the moe FFN", "ROADMAP queue 1 item 9d"),
    "recurrentgemma_2b": ("the rglru mixer", "ROADMAP queue 1 item 9d"),
    "whisper_small": ("the audio family", "ROADMAP queue 1 item 9d"),
    "internvl2_26b": ("the vlm family", "ROADMAP queue 1 item 9d"),
}


def get_config(name: str) -> ArchConfig:
    key = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    if key in _NOT_PORTED:
        what, item = _NOT_PORTED[key]
        raise NotImplementedError(
            f"arch {key!r} needs {what}, which the PyTorch port does not run "
            f"yet ({item}); the port runs: "
            f"{sorted(a for a in ARCH_IDS if a not in _NOT_PORTED)}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "reduced",
           "get_config", "ARCH_IDS"]
