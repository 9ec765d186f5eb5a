"""Llama-3.1 405B — the deep dense anchor.

[dense] 126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256
[arXiv:2407.21783]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b",
    family="dense",
    source="arXiv:2407.21783",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=5e5,
    norm="rmsnorm",
    act="swiglu",
)
