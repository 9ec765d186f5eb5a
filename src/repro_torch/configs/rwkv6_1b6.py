"""RWKV6 "Finch" 1.6B — attention-free, data-dependent decay.

[ssm] 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536 [arXiv:2404.05892]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    source="arXiv:2404.05892",
    n_layers=24,
    d_model=2048,
    n_heads=32,             # 2048 / 64 wkv heads (layout only; attn-free)
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    block_pattern=("wkv6",),
    wkv_head_dim=64,
    norm="layernorm",
    act="gelu",             # unused (rwkv channel-mix)
)
