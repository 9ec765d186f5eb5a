"""OLMoE-1B-7B — 64-expert top-8 MoE, every layer.

[moe] 16L d_model=2048 16H (kv=16) d_ff=1024 vocab=50304, MoE 64e top-8
[arXiv:2409.02060]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    source="arXiv:2409.02060",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab=50304,
    n_experts=64,
    top_k=8,
    qk_norm=True,           # OLMoE uses QK-norm
    norm="rmsnorm",
    act="swiglu",
)
