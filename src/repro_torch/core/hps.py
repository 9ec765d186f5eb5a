"""Hierarchical push-sum configuration and the parameter-server fusion.

The port of ``repro.core.hps``'s :class:`HPSConfig`, of :func:`hps_fusion`
on its ``F = 0``, all-reps-alive path — each representative keeps half of
its (z, m), the parameter server averages the halves over the M networks,
and pushes the average back (Algorithm 1 lines 13-21); a masked mean that
needs no kernel — and of :func:`ps_trimmed_pool`, the Byzantine-resilient
PS reduction of Algorithm 2 (lines 10-22).
"""
from __future__ import annotations

import dataclasses

import torch

from .graphs import EdgeList, HierTopology, edge_list, sort_by_dst

__all__ = ["HPSConfig", "hps_fusion", "ps_trimmed_pool"]


@dataclasses.dataclass(frozen=True)
class HPSConfig:
    """Static configuration of an HPS run."""

    topo: HierTopology
    gamma_period: int          # Γ — PS fusion every Γ iterations
    B: int = 1                 # link-reliability window
    drop_prob: float = 0.0     # packet-drop probability per link per round

    def edge_index(self) -> EdgeList:
        """The topology's dst-sorted sparse edge index."""
        el, _, _ = sort_by_dst(edge_list(self.topo.adj))
        return el


def hps_fusion(
    z: torch.Tensor, m: torch.Tensor, rep_mask: torch.Tensor, M: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the fusion at the representatives: ``0.5 * x + pool`` with
    ``pool = sum_reps x / (2 M)``. Non-representatives are untouched.

    ``M`` is the number of sub-networks (``topo.M``), not a count of the
    mask, exactly as in the reference."""
    repf = rep_mask.to(z.dtype)
    denom = 2.0 * M
    pooled_z = (z * repf[:, None]).sum(dim=0) / denom
    pooled_m = (m * repf).sum() / denom
    z_new = torch.where(rep_mask[:, None], 0.5 * z + pooled_z[None, :], z)
    m_new = torch.where(rep_mask, 0.5 * m + pooled_m, m)
    return z_new, m_new


def ps_trimmed_pool(
    pool: torch.Tensor,    # (R, *coord) candidate values at the PS
    valid: torch.Tensor,   # (R,) bool — pool membership mask
    F: int,
) -> torch.Tensor:
    """Trimmed mean over the parameter server's candidate pool, (*coord,).

    Per scalar coordinate independently: drop invalid slots, drop the F
    largest and F smallest of the rest, average the survivors (at least
    one in the denominator). A masked sort along the pool axis and a rank
    window, as the reference's single-virtual-receiver lowering through
    its sort-based trim; the pool holds one row per queried
    representative, so no kernel is needed.

    ``valid`` is the reference's pool mask, kept for parity with it: the
    reference clears the rows of churned representatives there. Algorithm
    2's fusion without faults passes an all-true mask (``deg = R``).
    """
    r = pool.reshape(pool.shape[0], -1)                    # (R, P)
    big = torch.finfo(r.dtype).max / 4
    s = torch.sort(torch.where(valid[:, None], r, big), dim=0).values
    deg = valid.sum()
    ranks = torch.arange(r.shape[0], device=r.device)[:, None]
    keep = (ranks >= F) & (ranks < deg - F)
    tsum = (s * keep.to(r.dtype)).sum(dim=0)
    kept = (deg - 2 * F).clamp_min(0).to(r.dtype)
    return (tsum / kept.clamp_min(1.0)).reshape(pool.shape[1:])
