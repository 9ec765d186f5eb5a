"""InternVL2-26B language backbone (InternLM2-20B-style GQA decoder).

[vlm] 48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553 — InternViT
vision encoder + MLP projector feed patch embeddings (the ViT is a stub per
the assignment carve-out; the projector + LM are real). [arXiv:2404.16821]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    source="arXiv:2404.16821",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    n_patches=256,          # 448x448 image, pixel-shuffle to 256 tokens
    rope_theta=1e6,
    act="swiglu",
    norm="rmsnorm",
)
