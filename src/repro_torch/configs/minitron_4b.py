"""Minitron-4B — width-pruned Nemotron-4.

[dense] 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000
[arXiv:2407.14679]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-4b",
    family="dense",
    source="arXiv:2407.14679",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab=256000,
    norm="layernorm",
    act="gelu",             # nemotron uses squared-relu; gelu is our closest
    rope_theta=1e4,
)
