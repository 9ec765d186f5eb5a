"""Analytic yardsticks of the port on its card: the H100's roofline
constants and terms (:mod:`.roofline`), the per-device memory model
(:mod:`.memory_model`), and the dry run's table (:mod:`.render`)."""
from .memory_model import (
    pushsum_device_memory_gb,
    serve_memory_gb,
    train_memory_gb,
)
from .roofline import HW, model_flops, pushsum_halo_wire_bytes, roofline_terms

__all__ = ["HW", "model_flops", "pushsum_halo_wire_bytes", "roofline_terms",
           "train_memory_gb", "serve_memory_gb", "pushsum_device_memory_gb"]
