"""Whisper-small — encoder-decoder ASR; conv+mel frontend is a stub.

[audio] 12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865 [arXiv:2212.04356]
The encoder consumes 1500 precomputed frame embeddings (stub frontend);
the 12-layer decoder has causal self-attention + cross-attention.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=12,             # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    encoder_layers=12,
    n_frames=1500,
    norm="layernorm",
    act="gelu",
    scan_layers=False,       # 12+12 shallow: unrolled
    tie_embeddings=True,
)
