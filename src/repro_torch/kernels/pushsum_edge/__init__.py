"""Push-sum edge scatter: the delivery and integration half of a robust
push-sum round, per directed edge e (src -> dst):

    rho_new[e] = sigma[src[e]]  if live[e] else rho[e]     (mask-latch)
    recv[v]   += rho_new[e] - rho[e]  for v = dst[e]       (integration)

:mod:`.ref` is the plain PyTorch version and :mod:`.ops` the route dispatch
and the CUDA kernel's wrapper.
"""
from .ops import dst_offsets, edge_scatter, edge_scatter_cuda
from .ref import edge_scatter_ref

__all__ = ["edge_scatter", "edge_scatter_cuda", "edge_scatter_ref",
           "dst_offsets"]
