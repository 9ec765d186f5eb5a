"""Hierarchical Byzantine-resilient non-Bayesian learning — Algorithm 2 / Thm 3.

The port of ``repro.core.byzantine`` on its synchronous, single-device
path. The curse of dimensionality of vector Byzantine
consensus is dodged by running one **scalar** dynamic per ordered
hypothesis pair (theta1, theta2): agent j's statistic ``r_t^j(t1, t2)``
accumulates trimmed-averaged neighbor statistics plus the *cumulative*
log-likelihood ratio of all its private signals so far (Eq. (11)).

Mechanics per iteration t:

* agents in a network in C (the healthy networks satisfying Assumptions
  3+4) broadcast r_{t-1}; receivers drop the F largest and F smallest
  received values and average the survivors with their own previous value,
  then add the cumulative LLR innovation (Alg. 2 lines 6-9);
* agents outside C are passive;
* every Γ iterations the parameter server queries max{2F+1, M} random
  representatives, trims F from each end, averages the rest into w_tilde,
  and pushes w_tilde to the queried representatives that are NOT in C
  (lines 10-22).

Gossip cores: ``core="sparse"`` trims on the padded neighbor-list layout
through :func:`repro_torch.kernels.byz_trim.trim_gather_pairs`, whose CUDA
kernel runs once per round; ``core="dense"`` broadcasts an (N, N, m, m)
message tensor filtered by :func:`trimmed_neighbor_mean` and is kept as the
equivalence oracle. ``mode="ovr"`` runs the one-vs-rest ablation through
the same loop with pair shape (m,).

The reference's ``lax.scan`` is a Python loop over ``t`` here, over K
scenarios in lockstep: a single run is the K = 1 case of the loop that
:mod:`repro_torch.core.sweeps` runs over a stacked runtime (one
block-diagonal neighbor-list graph of K·N receivers, each trimming its
own scenario's F). PRNG keys are host values folded up front in the
reference's disjoint domains ``3t + stream`` (:func:`stream_fold`), for
every scenario and round at once, so signals, ``random_noise`` lies and
the fusion's representative draws are the reference's bit for bit. ``t``
and each scenario's Γ are host ints, so the fusion rounds are chosen on
the host and their draws and pool sorts run only where a scenario fuses,
with no device sync.

The precision policy (``policy=``, :mod:`.precision`) carries the pairwise
statistic and the cumulative LLR at its storage dtype, casts the lies to
it, and runs the gossip trim (K3 on half storage on the card), the
fusion pool and the innovation arithmetic in its accum dtype; the
statistics come out float32.

Set-up: :func:`byzantine_runtime_from_edge_list` builds the runtime from a
sparse edge index with no (N, N) array — A3 once per distinct block
adjacency, one ``pairwise_kl`` for all agents, neighbor rows from the edge
runs — and gives the same arrays as :func:`make_byzantine_runtime`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..kernels.byz_trim import trim_gather_pairs
from .attacks import Attack
from .graphs import (
    EdgeList,
    HierTopology,
    check_assumption3,
    edge_list,
    edge_neighbor_lists,
)
from .faults import (ENGINE_BYZANTINE, FAULT_CHURN, FAULT_EDGE, FaultModel,
                     advance_faults_nbr, fault_stream_fold, init_fault_state,
                     ps_alive_rounds)
from .hps import ps_trimmed_pool
from .plan import ExecutionPlan, check_plan, resolve_device
from .precision import policy_dtypes
from .prng import (Key, choice, fold_in, fold_rounds, prng_key, randint,
                   split, uniform)
from .signals import SignalModel, pairwise_kl

__all__ = [
    "ByzantineConfig",
    "ByzantineResult",
    "ByzRuntime",
    "trimmed_neighbor_mean",
    "healthy_networks",
    "make_byzantine_runtime",
    "byzantine_runtime_from_edge_list",
    "gossip_adjacency",
    "make_byzantine_scan",
    "run_byzantine_runtime",
    "run_byzantine_learning",
    "run_byzantine_learning_ovr",
    "decide",
    "stream_fold",
]

MODES = ("pairwise", "ovr")
CORES = ("sparse", "dense")
STORES = ("trajectory", "decisions", "final")

# Per-iteration PRNG streams, each in the disjoint fold-in domain
# t * N_STREAMS + stream (the reference's values, carried verbatim).
N_STREAMS = 3
STREAM_SIGNAL, STREAM_GOSSIP, STREAM_FUSION = range(N_STREAMS)


def stream_fold(t: int, stream: int) -> int:
    """Fold-in value of ``stream`` at iteration ``t`` — injective over
    (t, stream), which keeps the three per-iteration streams
    non-colliding over any horizon."""
    return t * N_STREAMS + stream


@dataclasses.dataclass(frozen=True)
class ByzantineConfig:
    topo: HierTopology
    F: int                      # max number of Byzantine agents system-wide
    byz: tuple[int, ...]        # actual compromised agent indices, |byz| <= F
    gamma_period: int           # PS fusion period Γ
    attack: Attack

    def byz_mask(self) -> np.ndarray:
        m = np.zeros(self.topo.N, dtype=bool)
        for b in self.byz:
            m[b] = True
        return m


class ByzantineResult(NamedTuple):
    """Loop output; shapes depend on the store.

    ``"trajectory"``: ``r`` (T, N, m, m), ``decisions`` (T, N).
    ``"decisions"``: ``r`` is the final (N, m, m) only, ``decisions``
    still (T, N). ``"final"``: both final-step only, (N, m, m) / (N,).
    One-vs-rest runs carry pair shape (m, 1) instead of (m, m). Decisions
    are int32 hypothesis indices.
    """

    r: torch.Tensor
    decisions: torch.Tensor

    def to_numpy(self) -> tuple[np.ndarray, np.ndarray]:
        return self.r.cpu().numpy(), self.decisions.cpu().numpy()


# Host-side analysis memo tables. Assumption 3's reduced-graph enumeration
# is combinatorial in (block size, F), so the per-block verdict is keyed by
# (adjacency bytes, F); the full C set of a dense topology is keyed by the
# (topology, F, Byzantine set, model) fingerprint.
_A3_LATTICE: dict[tuple, bool] = {}
_C_SET_LATTICE: dict[tuple, tuple[int, ...]] = {}


def _check_a3_cached(block: np.ndarray, F: int) -> bool:
    key = (block.shape[0], F, block.tobytes())
    hit = _A3_LATTICE.get(key)
    if hit is None:
        hit = _A3_LATTICE[key] = check_assumption3(block, F=F)
    return hit


def _check_a4(kl: np.ndarray, F: int, tol: float = 1e-9) -> bool:
    """A4 for one network: ``kl`` (n, m, m) holds its normal agents'
    pairwise KLs. Every pair must stay distinguishable with the top-F
    contributors removed."""
    m = kl.shape[1]
    for a in range(m):
        for b in range(m):
            if a == b:
                continue
            contrib = np.sort(kl[:, a, b])       # ascending
            kept = contrib[:-F] if F > 0 else contrib
            if kept.sum() <= tol:                # distinguishers removable
                return False
    return True


def _healthy(sizes: Sequence[int], offsets: Sequence[int],
             block: Callable[[int], np.ndarray], byz_mask: np.ndarray,
             F: int, kl: np.ndarray | None) -> list[int]:
    """Indices of the networks in C, given each network's block adjacency
    (``block(i)``) and the (N, m, m) pairwise KLs of all agents (``None``
    skips A4)."""
    out = []
    for i, (off, sz) in enumerate(zip(offsets, sizes)):
        byz = byz_mask[off : off + sz]
        if int(byz.sum()) * 3 >= sz:  # >= 1/3 compromised cannot satisfy A3
            continue
        if not _check_a3_cached(block(i), F=F):
            continue
        if kl is not None and not _check_a4(kl[off : off + sz][~byz], F):
            continue
        out.append(i)
    return out


def _kl(model: SignalModel | None) -> np.ndarray | None:
    return (None if model is None
            else pairwise_kl(model.tables.cpu().numpy()))


def healthy_networks(topo: HierTopology, byz_mask: np.ndarray, F: int,
                     model: SignalModel | None = None) -> list[int]:
    """Indices of networks in C.

    A network qualifies iff (A3) every reduced graph has a single source
    component, and (A4) its *normal* agents can jointly distinguish every
    hypothesis pair, with the KL mass of the top-F contributors removed.
    Results are memoized per (topology, F, Byzantine set, model).
    """
    byz_mask = np.asarray(byz_mask)
    key = (
        topo.adj.tobytes(), topo.sizes, topo.offsets, F, byz_mask.tobytes(),
        None if model is None
        else (model.tables.cpu().numpy().tobytes(), model.truth),
    )
    hit = _C_SET_LATTICE.get(key)
    if hit is not None:
        return list(hit)
    out = _healthy(topo.sizes, topo.offsets, topo.block, byz_mask, F,
                   _kl(model))
    _C_SET_LATTICE[key] = tuple(out)
    return out


def trimmed_neighbor_mean(
    vals: torch.Tensor,     # (N, N, *pair) — vals[sender, receiver]
    adj: torch.Tensor,      # (N, N) bool
    F: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-receiver trimmed sum over in-neighbor values (Alg. 2 lines 8-9),
    the dense O(N^2 m^2 log N) lowering kept as the equivalence oracle.

    Returns ``(trimmed_sum (N, *pair), kept (N,))``: the sum over received
    values after dropping the F largest and F smallest, and the number
    kept, per receiver."""
    n = vals.shape[0]
    tail = (1,) * (vals.dim() - 2)
    big = torch.finfo(vals.dtype).max / 4
    # non-edges -> big so they sort to the high end
    masked = torch.where(adj.reshape(adj.shape + tail), vals, big)
    s = torch.sort(masked, dim=0).values       # ascending along senders
    deg = adj.sum(dim=0)                       # in-degree per receiver
    ranks = torch.arange(n, device=vals.device)[:, None]
    keep = (ranks >= F) & (ranks < (deg[None, :] - F))  # (rank, receiver)
    tsum = (s * keep.reshape(keep.shape + tail).to(vals.dtype)).sum(dim=0)
    return tsum, keep.sum(dim=0).to(vals.dtype)


# ---------------------------------------------------------------------------
# Runtime: the per-scenario tensors of one (topology, F, byz set) config
# ---------------------------------------------------------------------------

class ByzRuntime(NamedTuple):
    """Everything the loop reads that can vary per scenario.

    The reference's fields, plus ``byz_nbr``: whether a slot's sender is
    Byzantine does not change between rounds, so it is gathered once here
    rather than every round. One scenario's ``F`` and ``gamma`` are host
    ints: the trim kernel takes F as an argument and the loop picks fusion
    rounds on the host.

    The stacked form of K scenarios
    (:func:`repro_torch.core.sweeps.stack_runtimes`) is one block-diagonal
    neighbor-list graph of K·N receivers: scenario k's rows, the senders
    they name and its network ``offsets`` are shifted by k·N, every row
    padded to the common ``deg_max``. Its ``F`` and ``gamma`` are (K,)
    int numpy arrays, still on the host: the trim kernel takes F per
    receiver and each scenario fuses on its own Γ."""

    nbr_idx: torch.Tensor    # (N, deg_max) int32 in-neighbor sender per slot
    nbr_valid: torch.Tensor  # (N, deg_max) bool — False on padding slots
    byz_nbr: torch.Tensor    # (N, deg_max) bool — byz_mask[nbr_idx]
    byz_mask: torch.Tensor   # (N,) bool
    active: torch.Tensor     # (N,) bool — normal agents inside C networks
    in_C: torch.Tensor       # (N,) bool
    offsets: torch.Tensor    # (M,) int32 network block starts
    sizes: torch.Tensor      # (M,) int32 network block sizes
    F: int | np.ndarray      # trim count ((K,) when stacked)
    gamma: int | np.ndarray  # PS fusion period ((K,) when stacked)

    def to(self, device) -> "ByzRuntime":
        return ByzRuntime(*(x.to(device) if isinstance(x, torch.Tensor)
                            else x for x in self))


def _intra_edges(el: EdgeList, net_of: np.ndarray):
    """The valid edges whose ends lie in one network, ordered by receiver
    (stably) -> ``(src, dst)`` int64."""
    if el.is_batched:
        raise ValueError("pass one topology draw")
    src = el.src[el.valid].astype(np.int64)
    dst = el.dst[el.valid].astype(np.int64)
    same = net_of[src] == net_of[dst]
    src, dst = src[same], dst[same]
    order = np.argsort(dst, kind="stable")
    return src[order], dst[order]


def _assemble(C: list[int], src: np.ndarray, dst: np.ndarray,
              sizes: tuple[int, ...], offsets: np.ndarray,
              byz_mask: np.ndarray, F: int, gamma_period: int,
              deg_max: int | None):
    """The runtime of a C set over the intra-network edges ``(src, dst)``
    -> ``(runtime, extra_reps, n_reps)``."""
    if len(C) < F + 1:
        raise ValueError(
            f"Assumption 5 violated: |C|={len(C)} < F+1={F + 1}")
    if gamma_period < 1:
        raise ValueError(f"gamma_period must be >= 1, got {gamma_period}")
    M, N = len(sizes), byz_mask.shape[0]
    net_in_C = np.zeros(M, dtype=bool)
    net_in_C[C] = True
    in_C = np.repeat(net_in_C, sizes)
    active = in_C & ~byz_mask
    # gossip runs only inside C networks: keep the edges whose receiver is
    # in C (sender and receiver share a network already)
    keep = in_C[dst]
    nl = edge_neighbor_lists(
        EdgeList(src=src[keep].astype(np.int32),
                 dst=dst[keep].astype(np.int32), n=N,
                 valid=np.ones(int(keep.sum()), dtype=bool)),
        deg_max=deg_max)
    use_all_nets = M >= 2 * F + 1
    non_C_agents = np.nonzero(~in_C)[0].astype(np.int32)
    if not use_all_nets and len(non_C_agents) == 0:
        # degenerate: every network is healthy — query one rep per network
        use_all_nets = True
    n_reps = M if use_all_nets else 2 * F + 1
    extra_reps = None if use_all_nets else (
        tuple(int(c) for c in C), tuple(int(a) for a in non_C_agents),
        n_reps)
    rt = ByzRuntime(
        nbr_idx=torch.from_numpy(nl.idx),
        nbr_valid=torch.from_numpy(nl.valid),
        byz_nbr=torch.from_numpy(byz_mask[nl.idx]),
        byz_mask=torch.from_numpy(byz_mask.copy()),
        active=torch.from_numpy(active),
        in_C=torch.from_numpy(in_C),
        offsets=torch.tensor(offsets, dtype=torch.int32),
        sizes=torch.tensor(sizes, dtype=torch.int32),
        F=int(F),
        gamma=int(gamma_period),
    )
    return rt, extra_reps, n_reps


def byzantine_runtime_from_edge_list(
    model: SignalModel,
    el: EdgeList,
    sizes: Sequence[int],
    F: int,
    byz: Sequence[int],
    gamma_period: int,
):
    """Dense-free set-up of one config -> ``(runtime, extra_reps, n_reps)``
    (CPU tensors), the same values :func:`make_byzantine_runtime` gives for
    the dense topology of the same graph, built with no (N, N) array.

    ``el`` is the system's edge index (any order; a ``hier_edge_list`` or
    ``block_complete_edge_list`` is dst-sorted already) and ``sizes`` the
    network sizes, in agent order. Assumption 3 runs once per distinct
    block adjacency (memoized by its bytes), A4 reads one ``pairwise_kl``
    of all agents, and the neighbor rows come from the edge runs.
    """
    sizes = tuple(int(s) for s in sizes)
    if sum(sizes) != el.n:
        raise ValueError(f"network sizes sum to {sum(sizes)}, the edge "
                         f"index has {el.n} nodes")
    offsets = np.cumsum((0,) + sizes[:-1])
    byz_mask = np.zeros(el.n, dtype=bool)
    byz_mask[list(byz)] = True
    src, dst = _intra_edges(el, np.repeat(np.arange(len(sizes)), sizes))
    lo = np.searchsorted(dst, offsets, side="left")
    hi = np.searchsorted(dst, offsets + np.asarray(sizes), side="left")

    def block(i: int) -> np.ndarray:
        off, sz = offsets[i], sizes[i]
        b = np.zeros((sz, sz), dtype=bool)
        b[src[lo[i]:hi[i]] - off, dst[lo[i]:hi[i]] - off] = True
        return b

    C = _healthy(sizes, offsets, block, byz_mask, F, _kl(model))
    return _assemble(C, src, dst, sizes, offsets, byz_mask, F, gamma_period,
                     deg_max=None)


def make_byzantine_runtime(
    model: SignalModel,
    cfg: ByzantineConfig,
    deg_max: int | None = None,
):
    """Host-side set-up of one config -> ``(runtime, extra_reps, n_reps)``,
    the first three of the reference's four values (the dense oracle's
    (N, N) adjacency is :func:`gossip_adjacency` of the runtime).

    ``extra_reps`` is ``None`` when the all-networks representative rule
    applies (M >= 2F+1: one rep per network); otherwise it carries the
    static index tuples of the M < 2F+1 branch (the C networks, the agents
    outside C, and n_reps).
    """
    topo = cfg.topo
    byz_mask = cfg.byz_mask()
    C = healthy_networks(topo, byz_mask, cfg.F, model)
    src, dst = _intra_edges(edge_list(topo.adj), topo.network_of())
    return _assemble(C, src, dst, topo.sizes, np.asarray(topo.offsets),
                     byz_mask, cfg.F, cfg.gamma_period, deg_max)


def gossip_adjacency(rt: ByzRuntime) -> np.ndarray:
    """The (N, N) bool adjacency the runtime's neighbor lists encode:
    ``adj[i, j]`` iff i is one of j's valid slots."""
    idx, valid = rt.nbr_idx.cpu().numpy(), rt.nbr_valid.cpu().numpy()
    n = idx.shape[0]
    adj = np.zeros((n, n), dtype=bool)
    recv = np.broadcast_to(np.arange(n)[:, None], idx.shape)
    adj[idx[valid], recv[valid]] = True
    return adj




# ---------------------------------------------------------------------------
# Gossip lowerings (Alg. 2 lines 6-9)
# ---------------------------------------------------------------------------

def _scenario_keys(key: Key):
    """The K keys of a key of K numpy words, one by one, as Python ints."""
    return [Key(int(a), int(b)) for a, b in zip(key.k0, key.k1)]


def _sparse_gossip(key: Key, t: int, r: torch.Tensor, rt: ByzRuntime, *,
                   K: int, F, nbr_local: torch.Tensor, attack: Attack,
                   mode: str, backend: str, accum_dtype=None):
    """Neighbor-list trim-gather of K scenarios' K·N receivers in one call
    -> (trimmed_sum (K·N, *pair), kept (K·N,)). ``key`` holds K words,
    ``nbr_local`` (K, N, deg_max) the senders in scenario numbering and
    ``F`` the trim count (an int, or a (K·N,) tensor per receiver). The
    lies are cast to ``r``'s (storage) dtype; the sums are taken in
    ``accum_dtype``."""
    n, pair = r.shape[0], tuple(r.shape[1:])
    N, dm = n // K, rt.nbr_idx.shape[1]
    if attack.nbr_messages is not None:
        bmsg = attack.nbr_messages(key, t, r.view((K, N) + pair),
                                   nbr_local).reshape((n, dm) + pair)
    else:
        # compatibility path for attacks without a sparse form: build each
        # scenario's dense point-to-point tensor and gather its slots
        picked = []
        for k, kk in enumerate(_scenario_keys(key)):
            rk = r[k * N:(k + 1) * N]
            full = attack.messages(kk, t, rk if mode == "pairwise"
                                   else rk[:, :, None])
            if mode == "ovr":
                full = full[..., 0]
            picked.append(full[nbr_local[k].long(),
                               torch.arange(N, device=r.device)[:, None]])
        bmsg = torch.cat(picked)
    if bmsg.dtype != r.dtype:
        bmsg = bmsg.to(r.dtype)
    return trim_gather_pairs(r, rt.nbr_idx, rt.nbr_valid, bmsg, rt.byz_nbr,
                             F, backend, accum_dtype=accum_dtype)


def _dense_gossip(key: Key, t: int, r: torch.Tensor, rt: ByzRuntime, *,
                  K: int, F, nbr_local, attack: Attack, mode: str,
                  adj: torch.Tensor, accum_dtype=None):
    """(N, N) broadcast + sort oracle of one scenario -> (trimmed_sum,
    kept), on ``r`` upcast to ``accum_dtype``."""
    (key,) = _scenario_keys(key)
    if accum_dtype is not None:
        r = r.to(accum_dtype)
    n, pair = r.shape[0], tuple(r.shape[1:])
    honest = r[:, None].expand((n, n) + pair)
    if mode == "pairwise":
        byz = attack.messages(key, t, r)
    else:
        byz = attack.messages(key, t, r[:, :, None])[..., 0]
    sender = rt.byz_mask.reshape((n, 1) + (1,) * len(pair))
    msgs = torch.where(sender, byz, honest)
    if mode == "pairwise":
        return trimmed_neighbor_mean(msgs, adj, F)
    tsum, kept = trimmed_neighbor_mean(msgs[..., None], adj, F)
    return tsum[..., 0], kept


# ---------------------------------------------------------------------------
# PS fusion (Alg. 2 lines 10-22)
# ---------------------------------------------------------------------------

class _RepPlan(NamedTuple):
    """The M < 2F+1 representative branch, as device tensors."""

    C: torch.Tensor       # (|C|,) int64 network indices in C
    non_C: torch.Tensor   # (A,) int32 agents outside C
    n_reps: int


def _select_reps(key: Key, rt: ByzRuntime, plan: _RepPlan | None, K: int,
                 N: int) -> torch.Tensor:
    """Random representative selection for a fusion round of K scenarios
    -> (K, n_reps) int64 agent indices of the K·N. ``split(key, n)[i]`` is
    ``fold_in(key, i)``, so the reference's ``split(key, |C| + 1)`` is a
    tensor split of the first |C| keys and a host fold of the last; each
    scenario splits its own key, K at once."""
    dev = rt.offsets.device
    offs = rt.offsets.view(K, -1).long()
    sizes = rt.sizes.view(K, -1)
    if plan is None:
        keys = split(key, offs.shape[1], dev)               # (K, M)
        return offs + randint(keys, 0, sizes)
    # one rep from each network in C + (2F+1-|C|) uniform from outside C
    n_c = plan.C.shape[0]
    picks = offs[:, plan.C] + randint(split(key, n_c, dev), 0,
                                      sizes[:, plan.C])
    extra = torch.stack([choice(fold_in(kk, n_c), plan.non_C,
                                plan.n_reps - n_c)
                         for kk in _scenario_keys(key)]).long()
    shift = torch.arange(K, device=dev)[:, None] * N
    return torch.cat([picks, extra + shift], dim=1)


def _fusion(key: Key, t: int, r_in: torch.Tensor, rt: ByzRuntime, *,
            K: int, F, n_reps: int, rep_plan: _RepPlan | None,
            attack: Attack, live: torch.Tensor | None = None,
            accum_dtype=None):
    """PS fusion round of K scenarios: each queries its reps, trims its F
    from each end of its own pool (``F`` an int, or a (K,) tensor), and
    pushes its w_tilde back to its queried reps outside C. ``live`` (K·N,)
    bool (churn): dead representatives neither answer (their pool slots
    are masked) nor adopt. The pool is summed in ``accum_dtype`` and
    w_tilde goes back to ``r_in``'s dtype."""
    n, pair = r_in.shape[0], tuple(r_in.shape[1:])
    N = n // K
    sl = (K, n_reps) + (1,) * len(pair)
    reps = _select_reps(key, rt, rep_plan, K, N)           # (K, n_reps)
    rep_vals = r_in[reps]                                  # (K, n_reps, *pair)
    local = reps - torch.arange(K, device=reps.device)[:, None] * N
    if attack.nbr_messages is not None:
        reply = attack.nbr_messages(key, t, r_in.view((K, N) + pair),
                                    local[:, None, :])[:, 0].to(r_in.dtype)
    elif len(pair) == 2:
        reply = torch.stack([
            attack.ps_reply(kk, t, r_in[k * N:(k + 1) * N])[local[k]]
            for k, kk in enumerate(_scenario_keys(key))])
    else:
        reply = rep_vals        # no sparse reply defined: state is replayed
    rep_vals = torch.where(rt.byz_mask[reps].reshape(sl), reply, rep_vals)
    w = ps_trimmed_pool(
        rep_vals,
        torch.ones((K, n_reps), dtype=torch.bool, device=r_in.device)
        if live is None else live[reps], F,
        accum_dtype=accum_dtype).to(r_in.dtype)
    adopt = torch.zeros(n, dtype=torch.bool, device=r_in.device)
    adopt[reps.reshape(-1)] = True
    adopt &= ~rt.in_C
    if live is not None:
        adopt &= live
    return torch.where(adopt.view((K, N) + (1,) * len(pair)), w[:, None],
                       r_in.view((K, N) + pair)).view(r_in.shape)


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

def decide(r: torch.Tensor) -> torch.Tensor:
    """Decision rule: theta_hat = argmax_a min_{b != a} r(a, b).

    Theorem 3 guarantees a unique hypothesis whose pairwise statistics all
    diverge to +inf; with antisymmetric innovations that is theta*.
    r: (..., m, m) -> (...,) int32 decisions.
    """
    m = r.shape[-1]
    eye = torch.eye(m, dtype=torch.bool, device=r.device)
    worst = torch.where(eye, torch.inf, r).min(dim=-1).values
    return worst.argmax(dim=-1).to(torch.int32)


def _decisions(r: torch.Tensor, mode: str) -> torch.Tensor:
    return decide(r) if mode == "pairwise" \
        else r.argmax(dim=-1).to(torch.int32)


def _innovation(key: Key, cdf: torch.Tensor, log_tables: torch.Tensor,
                mode: str) -> torch.Tensor:
    """One private signal per agent of K scenarios -> per-pair statistic
    increment, (K·N, *pair). ``key`` is the round's (K, 1) tensor of keys,
    one (N,) uniform draw each; ``cdf`` and ``log_tables`` hold the K·N
    agents' rows."""
    n, m, S = log_tables.shape
    u = uniform(key, n // key.k0.shape[0], cdf.device).reshape(n)
    # searchsorted(side="left") over the inclusive cumsum counts the
    # entries strictly below u; clamp to the alphabet (an fp32 cumsum can
    # end below 1.0)
    sig = torch.searchsorted(cdf, u[:, None], side="left").clamp_max(S - 1)
    ll = torch.gather(log_tables, 2, sig[:, None, :].expand(n, m, 1))[..., 0]
    if mode == "pairwise":
        return ll[:, :, None] - ll[:, None, :]       # (n, m, m) antisymmetric
    eye = torch.eye(m, dtype=torch.bool, device=ll.device)
    rest = torch.where(eye[None], -torch.inf, ll[:, None, :])
    return ll - rest.max(dim=-1).values              # (n, m) one-vs-rest


def _scan_core(
    keys: Key,
    rt: ByzRuntime,
    *,
    gossip,                  # gossip(key, t, r, rt, K=, F=, nbr_local=)
    log_tables: torch.Tensor,  # (N, m, S) hoisted log-likelihood tables
    cdf: torch.Tensor,         # (N, S) hoisted truth-row inclusive cumsum
    T: int,
    mode: str,
    attack: Attack,
    store: str,
    rep_plan: _RepPlan | None,
    n_reps: int,
    faults: FaultModel | None = None,
    policy=None,
) -> ByzantineResult:
    """Algorithm 2's loop over K scenarios in lockstep, all on one device:
    ``keys`` holds K numpy words and ``rt`` is one scenario's runtime (K =
    1) or the stacked runtime of K. Every output has a leading K.

    Round keys are folded on the host up front for every scenario and
    stream; the signals of all K·N agents are one (K, N) draw, the gossip
    one trim-gather launch (F per receiver when stacked), and a fusion
    round, chosen on the host when any scenario's ``(t + 1) % Γ_k == 0``,
    draws every scenario's representatives from its own key and pools
    each scenario apart; the scenarios not fusing keep their state through
    ``torch.where``.

    ``faults`` (one :class:`repro_torch.core.faults.FaultModel` over every
    scenario) runs the fault plane on ``ENGINE_BYZANTINE``'s streams: each
    round's slot validity ``nbr_valid & ~drop & live[nbr_idx] & live``
    goes to K3, a dead agent's statistic and cumulative LLR freeze, dead
    representatives leave the fusion, and the PS coins of all T × K
    rounds, drawn on the host up front, are ANDed into the host's fusion
    rounds.

    ``policy`` carries r and the cumulative LLR at its storage dtype and
    runs the innovation sum, the gossip trim and update and the fusion
    pool in its accum dtype; the statistics come out float32."""
    N, m = log_tables.shape[0], log_tables.shape[1]
    st, _, ac = policy_dtypes(policy)
    accum = None if policy is None else ac
    K = len(keys.k0)
    dev = log_tables.device
    pair = (m, m) if mode == "pairwise" else (m,)
    n = K * N
    sl = (n,) + (1,) * len(pair)
    active = rt.active.reshape(sl)
    byz = rt.byz_mask.reshape(sl)
    dm = rt.nbr_idx.shape[1]
    nbr_local = (rt.nbr_idx.view(K, N, dm)
                 - torch.arange(K, dtype=torch.int32, device=dev)[:, None,
                                                                  None] * N)
    gammas = np.atleast_1d(np.asarray(rt.gamma, np.int64))
    if isinstance(rt.F, np.ndarray):
        F_recv = torch.from_numpy(np.repeat(rt.F, N).astype(np.int32)).to(dev)
        F_pool = torch.from_numpy(rt.F.astype(np.int64)).to(dev)
    else:
        F_recv = F_pool = rt.F
    fuse_at = (np.arange(1, T + 1)[:, None] % gammas[None, :]) == 0  # (T, K)
    fs = None
    if faults is not None:
        # PS crash: a fusion round is skipped where the server is down
        fuse_at &= ps_alive_rounds(keys, T, faults, engine=ENGINE_BYZANTINE)
        faults = faults.to(dev)
        fe, fc = (fold_rounds(keys, [fault_stream_fold(t, ENGINE_BYZANTINE, s)
                                     for t in range(T)], dev)
                  for s in (FAULT_EDGE, FAULT_CHURN))
        fs = init_fault_state(n, rt.nbr_idx.shape, dev)
    fuse_dev = torch.from_numpy(fuse_at).to(dev)
    if K > 1:
        log_tables = log_tables.repeat(K, 1, 1)
        cdf = cdf.repeat(K, 1)
    sig_keys = fold_rounds(keys, [stream_fold(t, STREAM_SIGNAL)
                                  for t in range(T)], dev)
    gos_keys = fold_rounds(keys, [stream_fold(t, STREAM_GOSSIP)
                                  for t in range(T)], None)
    fus_keys = fold_rounds(keys, [stream_fold(t, STREAM_FUSION)
                                  for t in range(T)], None)
    r = torch.zeros((n,) + pair, dtype=st, device=dev)
    cum_llr = torch.zeros_like(r)
    rs, decs = [], []
    live = None
    for t in range(T):
        rt_t = rt
        if fs is not None:
            fs, drop = advance_faults_nbr(Key(fe.k0[t], fe.k1[t]),
                                          Key(fc.k0[t], fc.k1[t]), faults, fs)
            live = fs.node_live
            # a dropped slot or a dead end silences the slot; the trim's
            # kept count shrinks with it
            rt_t = rt._replace(nbr_valid=rt.nbr_valid & ~drop
                               & live[rt.nbr_idx] & live[:, None])
        # ---- innovation accumulator (cumulative LLR of all signals so far)
        cum_new = (cum_llr.to(ac) + _innovation(
            Key(sig_keys.k0[t], sig_keys.k1[t]), cdf, log_tables,
            mode)).to(st)
        # dead agents observe no signal: the accumulator freezes
        cum_llr = cum_new if live is None else torch.where(
            live.reshape(sl), cum_new, cum_llr)
        # ---- intra-C gossip with trimming (lines 6-9)
        tsum, kept = gossip(Key(gos_keys.k0[t], gos_keys.k1[t]), t, r, rt_t,
                            K=K, F=F_recv, nbr_local=nbr_local,
                            accum_dtype=accum)
        r_gossip = ((tsum + r.to(ac)) / (kept.reshape(sl) + 1.0)
                    + cum_llr.to(ac))
        r_new = torch.where(active, r_gossip, r.to(ac)).to(st)
        if live is not None:
            # dead agents neither gossip nor update: stale rejoin
            r_new = torch.where(live.reshape(sl), r_new, r)
        # ---- PS fusion (lines 10-22) in the rounds where a scenario's Γ
        # divides t + 1 (and its PS is up), decided on the host
        if fuse_at[t].any():
            fused = _fusion(Key(fus_keys.k0[t], fus_keys.k1[t]), t, r_new,
                            rt, K=K, F=F_pool, n_reps=n_reps,
                            rep_plan=rep_plan, attack=attack, live=live,
                            accum_dtype=accum)
            r_new = fused if fuse_at[t].all() else torch.where(
                fuse_dev[t].view((K, 1) + (1,) * len(pair)),
                fused.view((K, N) + pair),
                r_new.view((K, N) + pair)).view(r_new.shape)
        # Byzantine agents' own state is meaningless; keep it at 0.
        r = torch.where(byz, 0.0, r_new)
        if store != "final":
            decs.append(_decisions(r, mode).view(K, N))
            if store == "trajectory":
                rs.append(r.view((K, N) + pair))
    tail = (lambda x: x[..., None]) if mode == "ovr" else (lambda x: x)

    def stack(xs, shape, dtype):
        return (torch.stack(xs, dim=1) if xs
                else torch.zeros((K, 0) + shape, dtype=dtype, device=dev))

    r_k = r.float().view((K, N) + pair)
    if store == "trajectory":
        return ByzantineResult(r=tail(stack(rs, (N,) + pair, r.dtype).float()),
                               decisions=stack(decs, (N,), torch.int32))
    if store == "decisions":
        return ByzantineResult(r=tail(r_k),
                               decisions=stack(decs, (N,), torch.int32))
    return ByzantineResult(r=tail(r_k),
                           decisions=_decisions(r, mode).view(K, N))


def _build_scan(model: SignalModel, rt: ByzRuntime, extra_reps, n_reps: int,
                attack: Attack, T: int, *, mode: str, core: str,
                backend: str, store: str, device,
                faults: FaultModel | None = None, policy=None):
    """Validate the options, move the runtime (one scenario's, or K
    stacked) and hoisted tables to the device once, and return
    ``run(keys) -> ByzantineResult`` with a leading K, ``keys`` a key of
    K numpy words."""
    accum = None if policy is None else policy_dtypes(policy)[2]
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if core not in CORES:
        raise ValueError(f"core must be one of {CORES}, got {core!r}")
    if store not in STORES:
        raise ValueError(f"store must be one of {STORES}, got {store!r}")
    if core == "dense" and isinstance(rt.F, np.ndarray):
        raise ValueError("the dense oracle runs one scenario at a time")
    if core == "dense" and faults is not None:
        # the dense oracle gossips over a fixed (N, N) adjacency and cannot
        # see the round's fault-silenced slots
        raise ValueError("faults need core='sparse'")
    dev = resolve_device(device)
    rt_d = rt.to(dev)
    rep_plan = None
    if extra_reps is not None:
        C, non_C, n_reps = extra_reps
        if n_reps - len(C) > len(non_C):
            raise ValueError(
                f"cannot query {n_reps - len(C)} representatives without "
                f"replacement from {len(non_C)} agents outside C")
        rep_plan = _RepPlan(
            C=torch.tensor(C, dtype=torch.int64, device=dev),
            non_C=torch.tensor(non_C, dtype=torch.int32, device=dev),
            n_reps=n_reps)
    if core == "sparse":
        gossip = functools.partial(_sparse_gossip, attack=attack, mode=mode,
                                   backend=backend, accum_dtype=accum)
    else:
        gossip = functools.partial(
            _dense_gossip, attack=attack, mode=mode,
            adj=torch.from_numpy(gossip_adjacency(rt)).to(dev),
            accum_dtype=accum)
    tables = model.tables.to(dev, torch.float32)
    return functools.partial(
        _scan_core,
        rt=rt_d,
        gossip=gossip,
        log_tables=torch.log(tables),
        cdf=torch.cumsum(tables[:, model.truth, :], dim=-1),
        T=T,
        mode=mode,
        attack=attack,
        store=store,
        rep_plan=rep_plan,
        n_reps=n_reps,
        faults=faults,
        policy=policy,
    )


def _one(key: Key) -> Key:
    """A single key as a key of one numpy word each."""
    return Key(np.asarray([key.k0], np.int64), np.asarray([key.k1], np.int64))


def _first(res: ByzantineResult) -> ByzantineResult:
    return ByzantineResult(r=res.r[0], decisions=res.decisions[0])


def make_byzantine_scan(
    model: SignalModel,
    cfg: ByzantineConfig,
    T: int,
    *,
    mode: str = "pairwise",
    core: str = "sparse",
    backend: str = "auto",
    store: str = "trajectory",
    policy=None,
    device=None,
) -> Callable[[Key], ByzantineResult]:
    """Build Algorithm 2's loop for a fixed (model, cfg, T).

    All host-side analysis (healthy networks, neighbor lists,
    representative sets) runs once here; the returned ``run(base_key)``
    runs the loop from a :class:`~repro_torch.core.prng.Key`. ``mode``
    selects pairwise (m, m) dynamics or the one-vs-rest (m,) ablation;
    ``core`` the sparse neighbor-list trim or the dense broadcast oracle;
    ``backend`` the sparse trim's route (:mod:`repro_torch.kernels.
    dispatch`); ``store`` what the loop keeps (:class:`ByzantineResult`);
    ``policy`` the precision policy (:mod:`repro_torch.core.precision`).
    The execution planes arrive only as plan fields, so the fault plane
    runs through :func:`run_byzantine_runtime` / :func:`run_byzantine_learning`.
    ``device=None`` means the card, and raises where there is none. The
    run is the one-scenario case of the loop the scenario sweeps run.
    """
    rt, extra_reps, n_reps = make_byzantine_runtime(model, cfg)
    run = _build_scan(model, rt, extra_reps, n_reps, cfg.attack, T,
                      mode=mode, core=core, backend=backend, store=store,
                      device=device, policy=policy)
    return lambda key: _first(run(_one(key)))


def run_byzantine_runtime(
    model: SignalModel,
    rt: ByzRuntime,
    extra_reps,
    n_reps: int,
    attack: Attack,
    T: int,
    seed: int = 0,
    *,
    mode: str = "pairwise",
    core: str = "sparse",
    plan: ExecutionPlan | None = None,
    device=None,
) -> ByzantineResult:
    """Run Algorithm 2 on a prebuilt runtime (the values of
    :func:`byzantine_runtime_from_edge_list` or
    :func:`make_byzantine_runtime`).

    ``plan.backend`` selects the trim route and ``plan.store`` what the
    loop keeps (``None`` means ``"trajectory"``); ``plan.dst_sorted`` is
    not read, as neighbor rows are receiver-major by construction.
    ``plan.faults`` runs the fault plane (sparse core only); the engine
    has no async mode, so ``plan.async_`` raises. ``plan.policy`` is the
    precision policy (K3 on half storage on the card). ``device=None``
    means the card, and raises where there is none; pass ``device="cpu"``
    to run the plain PyTorch path on the CPU.
    """
    plan = check_plan(plan, "run_byzantine_runtime",
                      ("backend", "store", "dst_sorted", "faults", "policy"))
    store = "trajectory" if plan.store is None else plan.store
    run = _build_scan(model, rt, extra_reps, n_reps, attack, T, mode=mode,
                      core=core, backend=plan.backend, store=store,
                      device=device, faults=plan.faults, policy=plan.policy)
    return _first(run(_one(prng_key(seed))))


def run_byzantine_learning(
    model: SignalModel,
    cfg: ByzantineConfig,
    T: int,
    seed: int = 0,
    *,
    mode: str = "pairwise",
    core: str = "sparse",
    plan: ExecutionPlan | None = None,
    device=None,
) -> ByzantineResult:
    """Run Algorithm 2 for T iterations (single scenario); see
    :func:`run_byzantine_runtime`."""
    check_plan(plan, "run_byzantine_learning",
               ("backend", "store", "dst_sorted", "faults", "policy"))
    rt, extra_reps, n_reps = make_byzantine_runtime(model, cfg)
    return run_byzantine_runtime(model, rt, extra_reps, n_reps, cfg.attack,
                                 T, seed, mode=mode, core=core, plan=plan,
                                 device=device)


def run_byzantine_learning_ovr(
    model: SignalModel,
    cfg: ByzantineConfig,
    T: int,
    seed: int = 0,
    **kwargs,
) -> ByzantineResult:
    """One-vs-rest variant of Algorithm 2: m dynamics on the one-vs-rest
    statistics r^j(theta), accumulating log l(s|theta) - max_{theta' !=
    theta} log l(s|theta'), with the same trimming and fusion. An ablation:
    Theorem 3's pairwise guarantee does not transfer verbatim.

    Returns a :class:`ByzantineResult` whose ``r`` has pair shape (m, 1).
    """
    kwargs.setdefault("mode", "ovr")
    return run_byzantine_learning(model, cfg, T, seed, **kwargs)
