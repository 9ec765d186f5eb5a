"""RecurrentGemma-2B (Griffin) — RG-LRU + local attention, 2:1 pattern.

[hybrid] 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000
[arXiv:2402.19427] — pattern: two recurrent blocks then one local-attention
block (window 2048).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    block_pattern=("rglru", "rglru", "swa"),
    window=2048,
    rnn_width=2560,
    norm="rmsnorm",
    act="geglu",
    tie_embeddings=True,
)
