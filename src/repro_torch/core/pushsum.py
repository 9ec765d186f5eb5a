"""Sparse edge-list robust push-sum — the consensus half of Algorithm 3.

The port of the synchronous path of ``repro.core.pushsum``'s edge-list
core. Each agent keeps a value ``z`` (N, d) and a mass ``m`` (N,), its
cumulative offer ``sigma`` per out-link, and each directed edge keeps the
cumulative value ``rho`` its receiver last heard. One round stages the
send, lets every operational edge latch the sender's new cumulative,
integrates the increments at the receivers and re-stages (Su '18 Alg. 1).

Layout: value and mass live in ONE (·, d+1) tensor whose last column is
the mass — ``zm`` (N, d+1), ``sigma_zm`` (N, d+1), ``rho_zm`` (E, d+1) —
so the edge scatter handles both recursions in one pass with no per-round
concat or split. ``z``/``m``/``sigma``/``sigma_m``/``rho``/``rho_m`` are
views of the reference's six fields.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.pushsum_edge import edge_scatter
from .prng import Key, fold_in, uniform

__all__ = [
    "SparsePushSumState",
    "init_sparse_state",
    "sparse_pushsum_step",
    "sparse_ratios",
    "sparse_mass_invariant",
    "step_edge_mask",
]


class SparsePushSumState(NamedTuple):
    zm: torch.Tensor        # (N, d+1) value columns, then the mass column
    sigma_zm: torch.Tensor  # (N, d+1) cumulative offered per out-link
    rho_zm: torch.Tensor    # (E, d+1) cumulative heard, per directed edge

    @property
    def z(self) -> torch.Tensor:
        return self.zm[:, :-1]

    @property
    def m(self) -> torch.Tensor:
        return self.zm[:, -1]

    @property
    def sigma(self) -> torch.Tensor:
        return self.sigma_zm[:, :-1]

    @property
    def sigma_m(self) -> torch.Tensor:
        return self.sigma_zm[:, -1]

    @property
    def rho(self) -> torch.Tensor:
        return self.rho_zm[:, :-1]

    @property
    def rho_m(self) -> torch.Tensor:
        return self.rho_zm[:, -1]

    def to_numpy(self) -> dict[str, np.ndarray]:
        """The reference's six fields as numpy arrays, by name."""
        return {f: getattr(self, f).detach().cpu().numpy()
                for f in ("z", "m", "sigma", "sigma_m", "rho", "rho_m")}


def init_sparse_state(w: torch.Tensor, n_edges: int) -> SparsePushSumState:
    """w: (N, d) initial values; ``n_edges`` the (padded) edge count E.
    Mass starts at 1, every cumulative at 0."""
    n, d = w.shape
    ones = torch.ones((n, 1), dtype=w.dtype, device=w.device)
    return SparsePushSumState(
        zm=torch.cat([w, ones], dim=1),
        sigma_zm=torch.zeros((n, d + 1), dtype=w.dtype, device=w.device),
        rho_zm=torch.zeros((n_edges, d + 1), dtype=w.dtype, device=w.device),
    )


def _out_degree(src: torch.Tensor, valid: torch.Tensor, n: int,
                dtype=torch.float32) -> torch.Tensor:
    """(N,) out-degree over valid edges."""
    return torch.zeros(n, dtype=dtype, device=src.device).index_add_(
        0, src, valid.to(dtype))


def sparse_pushsum_step(
    state: SparsePushSumState,
    mask: torch.Tensor,    # (E,) bool — operational edges this round
    src: torch.Tensor,     # (E,) int32 sender per edge
    dst: torch.Tensor,     # (E,) int32 receiver per edge
    valid: torch.Tensor,   # (E,) bool — False on padding edges
    backend: str = "auto",
    *,
    share: torch.Tensor | None = None,
    offsets: torch.Tensor | None = None,
) -> SparsePushSumState:
    """One synchronous fast-robust-push-sum round on edge-list state.

    ``share`` optionally supplies the hoisted (N,) ``1 / (d_out + 1)``
    factors of the fixed edge index. ``offsets`` optionally supplies the
    hoisted (N+1,) CSR offsets of a dst-sorted index for the CUDA edge
    scatter (:func:`repro_torch.kernels.pushsum_edge.edge_scatter`). The
    mask is intersected with ``valid``, so padding edges never carry mass.
    """
    zm, sigma_zm, rho_zm = state
    if share is None:
        share = 1.0 / (_out_degree(src, valid, zm.shape[0], zm.dtype) + 1.0)
    share = share[:, None]
    # first half: stage the cumulative send
    sigma_p = sigma_zm + zm * share
    # delivery + integration: operational edges latch the new cumulative
    rho_new, recv = edge_scatter(sigma_p, rho_zm, mask & valid, src, dst,
                                 backend, offsets=offsets)
    zm_p = zm * share + recv
    # second half: re-stage at once
    return SparsePushSumState(
        zm=zm_p * share,
        sigma_zm=sigma_p + zm_p * share,
        rho_zm=rho_new,
    )


def sparse_ratios(state: SparsePushSumState) -> torch.Tensor:
    """The push-sum estimate z/m per agent, (N, d)."""
    return state.z / state.m.clamp_min(1e-30)[:, None]


def sparse_mass_invariant(
    state: SparsePushSumState, src: torch.Tensor, valid: torch.Tensor,
) -> torch.Tensor:
    """sum_j zm_j + sum_{e valid} (sigma_zm[src[e]] - rho_zm[e]), (d+1,).

    The first d entries are the reference's invariant (``sum_j w_j``); the
    last is the total mass, which push-sum conserves at N."""
    in_flight = ((state.sigma_zm[src] - state.rho_zm)
                 * valid.to(state.zm.dtype)[:, None]).sum(dim=0)
    return state.zm.sum(dim=0) + in_flight


def step_edge_mask(
    key: Key,
    t: int,
    n_edges: int,
    drop_prob: torch.Tensor,
    B: torch.Tensor,
    fold_t: int | None = None,
) -> torch.Tensor:
    """(E,) operational mask for round t: i.i.d. Bernoulli keep with forced
    delivery at ``t % B == B - 1`` (the paper's B-connectivity window).

    ``fold_t`` overrides the fold-in value (default ``t``) so an engine
    with several streams per iteration gives the link mask its own fold
    domain while the B-window still runs on the iteration ``t``.
    ``drop_prob`` and ``B`` are 0-d tensors on the device the mask is drawn
    on; nothing is read back to the host.
    """
    kt = fold_in(key, t if fold_t is None else fold_t)
    up = uniform(kt, n_edges, drop_prob.device) >= drop_prob
    return up | ((t % B) == (B - 1))
