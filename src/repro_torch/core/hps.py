"""Hierarchical push-sum configuration and the parameter-server fusion.

The port of ``repro.core.hps``'s :class:`HPSConfig` and of
:func:`hps_fusion` on its ``F = 0``, all-reps-alive path: each
representative keeps half of its (z, m), the parameter server averages
the halves over the M networks, and pushes the average back (Algorithm 1
lines 13-21). With ``F = 0`` this is a masked mean and needs no kernel.
"""
from __future__ import annotations

import dataclasses

import torch

from .graphs import EdgeList, HierTopology, edge_list, sort_by_dst

__all__ = ["HPSConfig", "hps_fusion"]


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
