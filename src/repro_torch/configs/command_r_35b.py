"""Cohere Command-R 35B — GQA, parallel attn+FFN block, no biases.

[dense] 40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000
[hf:CohereForAI/c4ai-command-r-v01]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    parallel_block=True,    # Cohere parallel residual
    norm="layernorm",
    act="swiglu",
    rope_theta=8e6,
    tie_embeddings=True,    # command-r ties input/output embeddings
)
