"""Coordinate-wise trimmed mean over a worker axis: x (W, D) -> (D,), the
F largest and F smallest of each coordinate dropped and the rest averaged
(Algorithm 2's filter, the robust gradient aggregation of training).

:mod:`.ref` is the plain PyTorch version and :mod:`.ops` the route dispatch
and the CUDA kernel's wrapper.
"""
from .ops import W_MAX, trimmed_mean, trimmed_mean_cuda, trimmed_mean_pytree
from .ref import trimmed_mean_ref

__all__ = ["trimmed_mean", "trimmed_mean_pytree", "trimmed_mean_cuda",
           "trimmed_mean_ref", "W_MAX"]
