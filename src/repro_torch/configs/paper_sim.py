"""The paper's own experimental scale: a small decoder used by the
robust-training examples (hierarchical consensus over ~100M params)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paper-sim-100m",
    family="dense",
    source="this paper (Sec. VII simulation scale)",
    n_layers=8,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab=32000,
    norm="rmsnorm",
    act="swiglu",
    scan_layers=False,
)
