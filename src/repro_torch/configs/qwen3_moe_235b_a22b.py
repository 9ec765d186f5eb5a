"""Qwen3-MoE 235B-A22B — 128-expert top-8, GQA kv=4, deep stack.

[moe] 94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936, 128e top-8
[hf:Qwen/Qwen3-30B-A3B family scaling]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    n_experts=128,
    top_k=8,
    qk_norm=True,
    rope_theta=1e6,
    norm="rmsnorm",
    act="swiglu",
)
