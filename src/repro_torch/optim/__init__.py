"""AdamW with a cosine schedule and global-norm clipping."""
from .adamw import AdamWConfig, adamw_init, adamw_update, cosine_lr

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr"]
