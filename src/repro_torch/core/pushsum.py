"""Fast robust push-sum over packet-dropping links — the consensus half of
Algorithms 1 and 3.

The port of the synchronous path of ``repro.core.pushsum``. Each agent
keeps a value ``z`` (N, d) and a mass ``m`` (N,), its cumulative offer
``sigma`` per out-link, and each directed link keeps the cumulative value
``rho`` its receiver last heard. One round stages the send, lets every
operational link latch the sender's new cumulative, integrates the
increments at the receivers and re-stages (Su '18 Alg. 1).

Two state representations, as in the reference:

* **dense** (:class:`PushSumState`, ``rho`` (N, N, d)): the executable spec
  the sparse engine is tested against, for small N only;
* **sparse edge-list** (:class:`SparsePushSumState`, ``rho`` (E, d+1)):
  the engine; :func:`run_pushsum_sparse` runs it for T rounds with the
  delivery through the CUDA edge scatter on the card.

Layout: value and mass live in ONE (·, d+1) tensor whose last column is
the mass — ``zm`` (N, d+1), ``sigma_zm`` (N, d+1), ``rho_zm`` (E, d+1) —
so the edge scatter handles both recursions in one pass with no per-round
concat or split. ``z``/``m``/``sigma``/``sigma_m``/``rho``/``rho_m`` are
views of the reference's six fields.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.pushsum_edge import dst_offsets, edge_scatter
from .graphs import EdgeList, _dst_offsets, is_dst_sorted
from .plan import ExecutionPlan, resolve_device
from .prng import Key, fold_in, prng_key, uniform

__all__ = [
    "PushSumState",
    "init_state",
    "pushsum_step",
    "ratios",
    "run_pushsum",
    "mass_invariant",
    "SparsePushSumState",
    "init_sparse_state",
    "sparse_pushsum_step",
    "sparse_ratios",
    "sparse_mass_invariant",
    "run_pushsum_sparse",
    "step_edge_mask",
    "edge_mask",
]


# ---------------------------------------------------------------------------
# Dense reference implementation
# ---------------------------------------------------------------------------

class PushSumState(NamedTuple):
    z: torch.Tensor        # (N, d) value
    m: torch.Tensor        # (N,)   mass
    sigma: torch.Tensor    # (N, d) cumulative value offered per out-link
    sigma_m: torch.Tensor  # (N,)
    rho: torch.Tensor      # (N, N, d) cumulative value heard per in-link
    rho_m: torch.Tensor    # (N, N)


def init_state(w: torch.Tensor) -> PushSumState:
    """w: (N, d) initial values; push-sum drives z/m -> mean(w)."""
    n, d = w.shape
    zeros = functools.partial(torch.zeros, dtype=w.dtype, device=w.device)
    return PushSumState(z=w, m=torch.ones_like(w[:, 0]), sigma=zeros((n, d)),
                        sigma_m=zeros(n), rho=zeros((n, n, d)),
                        rho_m=zeros((n, n)))


def pushsum_step(
    state: PushSumState,
    mask: torch.Tensor,   # (N, N) bool — operational links this round
    adj: torch.Tensor,    # (N, N) bool — underlying topology (defines d_out)
) -> PushSumState:
    """One dense round. The mask is intersected with the topology, so a
    stray True on a non-edge never touches relay state."""
    z, m, sigma, sigma_m, rho, rho_m = state
    share = 1.0 / (adj.sum(dim=1).to(z.dtype) + 1.0)     # (N,)
    # first half: stage the cumulative send
    sigma_p = sigma + z * share[:, None]
    sigma_m_p = sigma_m + m * share
    # delivery: operational existing links latch the new cumulative
    live = mask & adj
    rho_new = torch.where(live[:, :, None], sigma_p[:, None, :], rho)
    rho_m_new = torch.where(live, sigma_m_p[:, None], rho_m)
    recv = (rho_new - rho).sum(dim=0)
    recv_m = (rho_m_new - rho_m).sum(dim=0)
    # integrate, then re-stage at once
    z_p = z * share[:, None] + recv
    m_p = m * share + recv_m
    return PushSumState(z_p * share[:, None], m_p * share,
                        sigma_p + z_p * share[:, None], sigma_m_p + m_p * share,
                        rho_new, rho_m_new)


def ratios(state: PushSumState) -> torch.Tensor:
    """The push-sum estimate z/m per agent, (N, d)."""
    return state.z / state.m.clamp_min(1e-30)[:, None]


def run_pushsum(
    w,                    # (N, d) inputs
    adj,                  # (N, N) bool topology
    masks,                # (T, N, N) bool operational-link schedule
    record_every: int = 1,
    *,
    device=None,
) -> tuple[PushSumState, torch.Tensor]:
    """Run T dense rounds -> final state and the (T // record_every, N, d)
    ratios after rounds ``record_every - 1, 2 record_every - 1, ...``.
    ``device=None`` means the card."""
    dev = resolve_device(device)
    adj = torch.as_tensor(adj, dtype=torch.bool, device=dev)
    masks = torch.as_tensor(masks, dtype=torch.bool, device=dev)
    state = init_state(torch.as_tensor(w, dtype=torch.float32, device=dev))
    traj = []
    for t in range(masks.shape[0]):
        state = pushsum_step(state, masks[t], adj)
        if (t + 1) % record_every == 0:
            traj.append(ratios(state))
    return state, _frames(traj, state.z)


def mass_invariant(state: PushSumState, adj: torch.Tensor) -> torch.Tensor:
    """sum_j z_j + sum_{(j', j) in E} (sigma_j' - rho_j'j), (d,): equal to
    sum_j w_j, the mass preservation Theorem 1 relies on."""
    adj_f = adj.to(state.z.dtype)
    in_flight = ((state.sigma[:, None, :] - state.rho)
                 * adj_f[:, :, None]).sum(dim=(0, 1))
    return state.z.sum(dim=0) + in_flight


def _frames(frames: list[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    """Recorded (N, d) frames stacked to (K, N, d), (0, N, d) if none."""
    return torch.stack(frames) if frames else like.new_zeros((0, *like.shape))


# ---------------------------------------------------------------------------
# Sparse edge-list implementation
# ---------------------------------------------------------------------------


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


def edge_index_tensors(el: EdgeList, e_max: int | None = None):
    """A single edge index as the engines' CPU tensors -> ``(src, dst,
    valid, offsets)``. ``e_max`` pads the edge axis with inert
    ``valid=False`` edges whose ``dst = N - 1``, which keeps a sorted
    layout sorted; ``offsets`` is the (N+1,) int32 CSR offsets of ``dst``
    when it is dst-sorted (the CUDA edge scatter's hoisted argument), else
    ``None``."""
    if el.is_batched:
        raise ValueError("pass one topology draw")
    src, dst, valid = el.src, el.dst, el.valid
    if e_max is not None:
        pad = e_max - el.E
        if pad < 0:
            raise ValueError(f"e_max={e_max} < edge count {el.E}")
        src = np.concatenate([src, np.zeros(pad, np.int32)])
        dst = np.concatenate([dst, np.full(pad, el.n - 1, np.int32)])
        valid = np.concatenate([valid, np.zeros(pad, bool)])
    for name, idx in (("src", src), ("dst", dst)):
        if idx.size and not (idx.min() >= 0 and idx.max() < el.n):
            raise ValueError(f"{name} indices must lie in [0, {el.n})")
    offsets = (torch.from_numpy(_dst_offsets(dst, el.n))
               if is_dst_sorted(dst) else None)
    return (torch.tensor(src, dtype=torch.int32),
            torch.tensor(dst, dtype=torch.int32),
            torch.tensor(valid, dtype=torch.bool), offsets)


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
    on; nothing is read back to the host. A batch of K scenarios passes a
    tensor of K keys of shape (K, 1) with ``drop_prob`` and ``B`` of shape
    (K,), and gets their (K·E,) masks, scenario k's at ``[k E, (k+1) E)``.
    """
    return edge_mask(fold_in(key, t if fold_t is None else fold_t), t,
                     n_edges, drop_prob, B)


def edge_mask(kt: Key, t: int, n_edges: int, drop_prob: torch.Tensor,
              B: torch.Tensor) -> torch.Tensor:
    """:func:`step_edge_mask` from the round's already-folded key ``kt``
    (one key, or a (K, 1) tensor of keys with (K,) ``drop_prob`` and
    ``B``) -> (E,) or (K·E,)."""
    up = uniform(kt, n_edges, drop_prob.device) >= drop_prob[..., None]
    return (up | ((t % B) == (B - 1))[..., None]).reshape(-1)


def run_pushsum_sparse(
    w,                     # (N, d) inputs
    src,                   # (E,) int32
    dst,                   # (E,) int32
    T: int,
    *,
    drop_prob: float = 0.0,
    B: int = 1,
    key: Key | None = None,
    valid=None,
    masks=None,            # optional explicit (T, E) bool schedule
    record_every: int = 1,
    plan: ExecutionPlan | None = None,
    device=None,
) -> tuple[SparsePushSumState, torch.Tensor]:
    """Run T synchronous rounds of the edge-list core.

    Masks are (E,) Bernoulli draws from ``key`` (default ``prng_key(0)``)
    folded at the plain round index ``t``, with forced delivery at ``t %
    B == B - 1``: the reference's draws bit for bit. An explicit ``masks``
    (T, E) schedule replaces them (see :func:`graphs.edge_masks`); its
    length must be T. ``valid`` (default all True) marks padding edges.

    Returns the final state and the ratios recorded after rounds
    ``record_every - 1, 2 record_every - 1, ...``: only those frames are
    kept, so ``record_every = T`` holds one (N, d) frame.

    ``plan.backend`` picks the delivery route and ``plan.dst_sorted``
    asserts (and checks) a dst-sorted index; the share factors and the
    CSR offsets of a sorted index are computed once, before the loop.
    ``device=None`` means the card, and raises where there is none.
    """
    plan = ExecutionPlan() if plan is None else plan
    dev = resolve_device(device)
    w = torch.as_tensor(w, dtype=torch.float32, device=dev)
    src = torch.as_tensor(src, dtype=torch.int32, device=dev)
    dst = torch.as_tensor(dst, dtype=torch.int32, device=dev)
    E = src.shape[0]
    valid = (torch.ones(E, dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, dtype=torch.bool, device=dev))
    if masks is not None:
        masks = torch.as_tensor(masks, dtype=torch.bool, device=dev)
        if masks.shape[0] != T:
            raise ValueError(
                f"masks schedule has {masks.shape[0]} rounds but T={T}")
    # loop invariants of the fixed edge index, read back once
    offsets = None
    if E and bool((dst[1:] >= dst[:-1]).all()):
        offsets = dst_offsets(dst, w.shape[0])
    elif plan.dst_sorted:
        raise ValueError("plan.dst_sorted=True but the edge index is not "
                         "dst-sorted")
    share = 1.0 / (_out_degree(src, valid, w.shape[0]) + 1.0)
    key = prng_key(0) if key is None else key
    drop = torch.tensor(drop_prob, dtype=torch.float32, device=dev)
    Bt = torch.tensor(B, dtype=torch.int32, device=dev)
    state = init_sparse_state(w, E)
    traj = []
    for t in range(T):
        mask = (masks[t] if masks is not None
                else step_edge_mask(key, t, E, drop, Bt))
        state = sparse_pushsum_step(state, mask, src, dst, valid,
                                    plan.backend, share=share,
                                    offsets=offsets)
        if (t + 1) % record_every == 0:
            traj.append(sparse_ratios(state))
    return state, _frames(traj, state.z)
