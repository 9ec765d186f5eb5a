"""Plain PyTorch version of the push-sum edge scatter: gather + where +
``index_add_``, the port of ``repro.kernels.pushsum_edge.ref``.

    rho_new[e] = sigma[src[e]] if live[e] else rho[e]
    recv[v]    = sum_{e : dst[e] == v} (rho_new[e] - rho[e])

``sigma``'s rows are the sources ``src`` indexes: the nodes, or the async
engines' per-edge snapshot with the identity index; ``n_recv`` (default
``sigma``'s row count) is the number of receivers.

``sigma`` and ``rho`` carry the value columns and the mass column as one
(·, d+1) matrix, so one reduction serves both push-sum recursions. Any edge
order is accepted. The CPU path of the engines runs this, and the CUDA
kernel is held against it.

``accum_dtype`` is the precision policy's accumulation slot: ``rho_new``
stays in the storage dtype of ``rho`` and ``recv`` is the sum of the
increments ``rho_new - rho`` taken in ``accum_dtype`` (``None`` keeps the
input dtype, the pre-policy program).
"""
from __future__ import annotations

import torch

__all__ = ["edge_scatter_ref"]


def edge_scatter_ref(
    sigma: torch.Tensor,   # (n_src, D) staged cumulative send per source
    rho: torch.Tensor,     # (E, D) last heard cumulative per edge
    live: torch.Tensor,    # (E,) bool — operational AND valid this round
    src: torch.Tensor,     # (E,) int32
    dst: torch.Tensor,     # (E,) int32
    *,
    n_recv: int | None = None,
    accum_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(rho_new (E, D), recv (n_recv, D))``."""
    n = sigma.shape[0] if n_recv is None else n_recv
    ad = rho.dtype if accum_dtype is None else accum_dtype
    rho_new = torch.where(live[:, None], sigma[src], rho)
    recv = rho.new_zeros((n, sigma.shape[1]), dtype=ad).index_add_(
        0, dst, rho_new.to(ad) - rho.to(ad))
    return rho_new, recv
