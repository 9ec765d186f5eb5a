"""Hierarchical push-sum (HPS) — Algorithm 1 of the paper.

The port of ``repro.core.hps`` on its single-device path. M sub-networks each run fast robust push-sum in parallel
(block-diagonal adjacency); every Γ iterations each network's designated
representative pushes half of its (value, mass) to the parameter server,
which averages the halves and pushes the average back:

    z_rep <- 1/2 z_rep + 1/(2M) sum_i z_{i0}
    m_rep <- 1/2 m_rep + 1/(2M) sum_i m_{i0}

Theorem 1: with Γ = B D*, the consensus error decays as ``gamma^(t / 2Γ)``
with ``gamma = 1 - (1/4M^2) (min_i beta_i)^(2 D* B)``
(:func:`theorem1_bound`).

The engine (:func:`run_hps_runtime`) runs the consensus half of every
iteration on the sparse edge-list core
(:func:`repro_torch.core.pushsum.sparse_pushsum_step`), whose delivery is
the CUDA edge scatter on the card. The reference's ``lax.scan`` is a
Python loop over ``t`` that reads nothing back to the host: ``drop_prob``,
``gamma``, ``B`` and ``M`` are device tensors of an :class:`HPSRuntime`,
the fusion round ``(t + 1) % gamma == 0`` is selected with
``torch.where``, and the per-round link masks are drawn on the
``hps_stream_fold(t) = ~t`` fold domain, the reference's bit for bit. The
share factors, the CSR offsets, the consensus target and every round's
folded key are hoisted out of the loop. A grid of scenarios
(:mod:`repro_torch.core.sweeps`) runs through the same loop as one
block-diagonal graph.

``store`` selects what the loop keeps: ``"trajectory"`` the (T, N, d)
ratio history, ``"gap"`` one 0-d tensor a round, the worst consensus error
``max_{j,k} |z_j/m_j - mean(w)|`` (Theorem 1's left side), stacked to (T,)
after the loop, plus the final ratios, and ``"final"`` the final ratios
only.

PS-side fusion: ``F = 0`` is the exact Algorithm 1 fusion above (a masked
mean); ``F > 0`` drops the F largest and F smallest representative
contributions per coordinate before averaging (:func:`ps_trimmed_pool`),
the rule Algorithm 2's parameter server reduces through as well. The
trimmed rule is resilient, not average-preserving.

The precision policy (``plan.policy``, :mod:`.precision`) stores the
state at its storage dtype; the fusion pools are summed in the accum
dtype and the results go back to storage; the ratio and gap diagnostics
are float32.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.byz_trim.ref import trim_gather_ref
from ..statics.contracts import contract as statics_contract
from ..statics.dense import HORIZON_KEYS
from .asyncrony import AsyncModel, is_degenerate_async
from .faults import ENGINE_HPS, FaultModel, ps_alive_rounds
from .graphs import EdgeList, HierTopology, edge_list, sort_by_dst
from .plan import ExecutionPlan, check_plan, resolve_device
from .precision import policy_dtypes
from .prng import Key, fold_rounds, prng_key
from .pushsum import (
    PlaneRounds,
    PushSumState,
    SparsePushSumState,
    _frames,
    _out_degree,
    edge_index_tensors,
    init_sparse_state,
    init_state,
    plane_step,
    pushsum_step,
    ratios,
    round_mask,
    sparse_ratios,
    step_edge_mask,
)

__all__ = [
    "HPSConfig",
    "HPSResult",
    "HPSRuntime",
    "HPS_STORES",
    "hps_stream_fold",
    "ps_trimmed_pool",
    "hps_fusion",
    "hps_step",
    "make_hps_runtime",
    "hps_runtime_from_edge_list",
    "run_hps",
    "run_hps_runtime",
    "run_hps_dense",
    "theorem1_bound",
]

HPS_STORES = ("trajectory", "gap", "final")


def hps_stream_fold(t: int) -> int:
    """Fold-in value of the HPS link-mask stream at iteration ``t``: ``~t``.

    A negative Python int, which :func:`repro_torch.core.prng.fold_in`
    reinterprets as its uint32 pattern ``2^32 - 1 - t``, as the reference's
    ``~np.int32(t)`` is: the stream lives at the top of the fold domain,
    disjoint from the social engine's ``2t + s`` and the Byzantine
    engine's ``3t + s`` for any horizon below 2^31 / 3."""
    return ~t


@dataclasses.dataclass(frozen=True)
class HPSConfig:
    """Static configuration of an HPS run."""

    topo: HierTopology
    gamma_period: int          # Γ — PS fusion every Γ iterations
    B: int = 1                 # link-reliability window
    drop_prob: float = 0.0     # packet-drop probability per link per round

    def rep_mask(self) -> torch.Tensor:
        """(N,) bool designated representatives."""
        return torch.from_numpy(self.topo.rep_mask())

    def adj(self) -> torch.Tensor:
        """(N, N) bool block-diagonal adjacency."""
        return torch.from_numpy(np.asarray(self.topo.adj, bool))

    def edge_index(self) -> EdgeList:
        """The topology's dst-sorted sparse edge index."""
        el, _, _ = sort_by_dst(edge_list(self.topo.adj))
        return el


# ---------------------------------------------------------------------------
# PS-side fusion: one masked-pool reduction for Algorithms 1 and 2
# ---------------------------------------------------------------------------

def ps_trimmed_pool(
    pool: torch.Tensor,    # (R, *coord), or (K, R, *coord) for K pools
    valid: torch.Tensor,   # (R,) or (K, R) bool — pool membership mask
    F,                     # int, or (K,) int tensor: each pool's own F
    *,
    accum_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Trimmed mean over the parameter server's candidate pool, (*coord,),
    or over each of K pools at once, (K, *coord).

    Per scalar coordinate independently: drop invalid slots, drop the F
    largest and F smallest of the rest, average the survivors (at least
    one in the denominator). Routed, as in the reference, through the
    plain trim-gather (:func:`repro_torch.kernels.byz_trim.
    trim_gather_ref`, with its NaN-canonical sort), each pool one virtual
    receiver whose slots are its rows, trimming its own F. The pool is
    Algorithm 2's queried representatives, or Algorithm 1's whole (N,
    d+1) state masked to the representatives (up to N slots, past K3's
    64), once every Γ rounds: it stays plain on every device.
    ``accum_dtype`` is the dtype of the survivor sums and the mean
    (``None``: the pool's).
    """
    batched = valid.dim() == 2
    if not batched:
        pool, valid = pool[None], valid[None]
    K, R = valid.shape
    r = pool.reshape(K * R, -1)                            # (K R, P)
    tsum, kept = trim_gather_ref(
        r,
        torch.arange(K * R, dtype=torch.int32, device=r.device).view(K, R),
        valid,
        r.new_zeros(()).expand(K, R, r.shape[1]),          # no substitution
        torch.zeros((K, R), dtype=torch.bool, device=r.device),
        F,
        accum_dtype,
    )
    out = (tsum / kept.clamp_min(1.0)[:, None]).reshape(
        (K,) + tuple(pool.shape[2:]))
    return out if batched else out[0]


def _fuse(zm: torch.Tensor, rep_mask: torch.Tensor, M,
          F: int = 0, live: torch.Tensor | None = None,
          accum_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The fusion on the joint (K, N, d+1) value-and-mass state of K
    scenarios (``rep_mask`` (K, N), ``M`` an int or a (K,) tensor): each
    representative keeps half and adds the halves pooled over its own
    scenario's representatives (with F > 0, K trimmed pools at once).

    ``live`` (K, N) bool (churn): only live representatives pool and
    adopt; at F = 0 the weight ``1 / 2M`` becomes ``1 / (2 max(live
    reps, 1))``, so the fusion keeps the live representatives' mass.
    ``accum_dtype`` is the dtype the pools and the update run in; the
    result is in ``zm``'s dtype (``None``: all in ``zm``'s)."""
    ad = zm.dtype if accum_dtype is None else accum_dtype
    eff = rep_mask if live is None else rep_mask & live
    za = zm.to(ad)
    if F == 0:
        if live is not None:
            M = eff.sum(dim=-1, keepdim=True).to(ad).clamp_min(1.0)
        elif torch.is_tensor(M) and M.ndim:
            M = M[:, None]
        pooled = ((za * eff.to(ad)[..., None]).sum(dim=-2) / (2.0 * M))
    else:
        pooled = 0.5 * ps_trimmed_pool(zm, eff, F, accum_dtype=accum_dtype)
    return torch.where(eff[..., None], 0.5 * za + pooled[:, None, :],
                       za).to(zm.dtype)


def hps_fusion(
    z: torch.Tensor, m: torch.Tensor, rep_mask: torch.Tensor, M, F: int = 0,
    *, live: torch.Tensor | None = None,
    accum_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply the hierarchical fusion at the representatives; the others
    are untouched.

    ``F = 0``: ``0.5 * x + sum_reps x / (2 M)``, lines 13-21 of Algorithm
    1. ``M`` is the number of sub-networks (``topo.M``, a Python int or a
    0-d tensor on the state's device), not a count of the mask, exactly as
    in the reference. ``F > 0``: ``0.5 * x + 0.5 * ps_trimmed_pool(...)``
    over the representatives' (z, m) rows, which needs ``M >= 2F + 1``
    and is not average-preserving. ``live`` (N,) bool: only live
    representatives pool and adopt (:func:`_fuse`). ``accum_dtype``: the
    pools run in it and (z, m) come back in their own dtype."""
    zm = _fuse(torch.cat([z, m[:, None]], dim=1)[None], rep_mask[None], M,
               F, None if live is None else live[None], accum_dtype)[0]
    return zm[:, :-1], zm[:, -1]


def hps_step(
    state: PushSumState,
    mask: torch.Tensor,
    adj: torch.Tensor,
    rep_mask: torch.Tensor,
    M: int,
    do_fusion,             # bool or 0-d bool tensor — (t + 1) % Γ == 0
) -> PushSumState:
    """One dense HPS iteration: robust push-sum, then (where ``do_fusion``)
    the PS fusion. The (N, N)-mask step :func:`run_hps_dense` runs."""
    st = pushsum_step(state, mask, adj)
    z_f, m_f = hps_fusion(st.z, st.m, rep_mask, M)
    do = torch.as_tensor(do_fusion, device=st.z.device)
    return st._replace(z=torch.where(do, z_f, st.z),
                       m=torch.where(do, m_f, st.m))


# ---------------------------------------------------------------------------
# Runtime: the per-scenario tensors of one (topology, M, Γ, drop, B) config
# ---------------------------------------------------------------------------

class HPSResult(NamedTuple):
    """Engine output; shapes depend on the store.

    ``"trajectory"``: ``ratio`` (T, N, d) and ``gap`` (T,), derived after
    the loop. ``"gap"``: ``ratio`` the final (N, d) and ``gap`` the (T,)
    curve reduced each round. ``"final"``: ``ratio`` (N, d) and the final
    0-d ``gap``.
    """

    ratio: torch.Tensor
    final_state: SparsePushSumState
    gap: torch.Tensor


class HPSRuntime(NamedTuple):
    """Everything the loop reads that can vary per scenario, as tensors.

    ``offsets`` is the hoisted (N+1,) int32 CSR offsets of ``dst`` for the
    CUDA edge scatter, or ``None`` when the index is not dst-sorted (the
    CUDA route then raises). ``M`` is the topology's sub-network count, the
    fusion weight's ``1 / 2M``."""

    src: torch.Tensor             # (E,) int32 sender per edge
    dst: torch.Tensor             # (E,) int32 receiver per edge
    valid: torch.Tensor           # (E,) bool — False on padding edges
    offsets: torch.Tensor | None  # (N+1,) int32 CSR offsets of dst
    rep_mask: torch.Tensor        # (N,) bool — designated representatives
    drop_prob: torch.Tensor       # () f32 per-link packet-drop probability
    gamma: torch.Tensor           # () i32 PS fusion period
    B: torch.Tensor               # () i32 link-reliability window
    M: torch.Tensor               # () i32 sub-network count

    def to(self, device) -> "HPSRuntime":
        return HPSRuntime(*(None if x is None else x.to(device)
                            for x in self))


def hps_runtime_from_edge_list(
    el: EdgeList,
    rep_mask: np.ndarray,
    *,
    drop_prob: float,
    gamma_period: int,
    B: int = 1,
    M: int | None = None,
    e_max: int | None = None,
) -> HPSRuntime:
    """Build an :class:`HPSRuntime` (CPU tensors) from a sparse edge index,
    with no (N, N) array (pair with :func:`graphs.hier_edge_list`).

    ``M`` defaults to the representative count; ``e_max`` pads the edge
    axis with inert ``valid=False`` edges whose ``dst = N - 1``, which keeps
    a sorted layout sorted. The CSR offsets are computed here, once, when
    the index is dst-sorted."""
    rep_mask = np.asarray(rep_mask, bool)
    return HPSRuntime(
        *edge_index_tensors(el, e_max),
        rep_mask=torch.from_numpy(rep_mask.copy()),
        drop_prob=torch.tensor(drop_prob, dtype=torch.float32),
        gamma=torch.tensor(gamma_period, dtype=torch.int32),
        B=torch.tensor(B, dtype=torch.int32),
        M=torch.tensor(int(rep_mask.sum()) if M is None else M,
                       dtype=torch.int32),
    )


def make_hps_runtime(cfg: HPSConfig, e_max: int | None = None) -> HPSRuntime:
    """Host-side set-up of one :class:`HPSConfig` scenario."""
    return hps_runtime_from_edge_list(
        cfg.edge_index(),
        cfg.topo.rep_mask(),
        drop_prob=cfg.drop_prob,
        gamma_period=cfg.gamma_period,
        B=cfg.B,
        M=cfg.topo.M,
        e_max=e_max,
    )


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------

@statics_contract(
    name="hps",
    forbidden={
        "*": (("N", "N"),),
        "final": (("T", "*"),),
        "gap": (("T", "*"),),
    },
    # One link-mask stream at the TOP of the uint32 fold-in space (~t):
    # one experiment seed may root this engine together with the social or
    # Byzantine engines, so the analyzer must also prove cross-engine
    # disjointness against both.
    streams=(("link", hps_stream_fold),),
    shares_seed_with=("social", "byzantine"),
    exempt=(HORIZON_KEYS,),
)
def _hps_scan_core(
    key: Key,
    rt: HPSRuntime,
    w: torch.Tensor,       # (N, d) initial values
    *,
    T: int,
    store: str,
    backend: str,
    F: int = 0,
    faults: FaultModel | None = None,
    async_: AsyncModel | None = None,
    policy=None,
) -> tuple[SparsePushSumState, tuple[torch.Tensor, torch.Tensor]]:
    """Algorithm 1's loop over the runtime's tensors, all on ``w``'s device.

    Returns ``(final_state, (ratio, gap))`` with the store-dependent shapes
    of :class:`HPSResult`. A runtime of K scenarios stacked into one
    block-diagonal graph (:func:`repro_torch.core.sweeps.stack_runtimes`:
    K·N nodes, (K,) scalars) runs them in lockstep from a key of K words,
    each scenario starting from ``w``: one consensus step and one fusion a
    round for all of them, and every output gains a leading K. A runtime
    with 0-d scalars is the one-scenario case and keeps the unbatched
    shapes.

    ``faults`` (0-d or (K,) leaves) runs the fault plane on ``ENGINE_HPS``:
    the Gilbert–Elliott chain and churn on their streams, the link
    uniforms on the ``~t`` fold, dead agents frozen, dead representatives
    out of the fusion, and a fusion round skipped where the PS coin (all
    T × K drawn on the host up front) says the server is down.
    ``async_`` runs the async plane (wake coins on ``ENGINE_HPS``'s
    stream, delivery from the per-edge buffer through K1); the fusion
    stays on the global Γ clock. ``policy`` keeps the state at its
    storage dtype, with the receiver sums and the fusion pools in its
    accum dtype; ratios and gaps are float32."""
    N, d = w.shape
    ac = policy_dtypes(policy)[2]
    K = rt.drop_prob.numel()
    E = rt.src.shape[0] // K
    drop, gamma, B, M = (x.reshape(-1) for x in (rt.drop_prob, rt.gamma,
                                                  rt.B, rt.M))
    rep = rt.rep_mask.view(K, N)
    state = init_sparse_state(w.repeat(K, 1), K * E, policy)
    # loop invariants of the fixed edge index and inputs
    share = 1.0 / (_out_degree(rt.src, rt.valid, K * N, w.dtype) + 1.0)
    target = w.mean(dim=0)
    keys = fold_rounds(key, [hps_stream_fold(t) for t in range(T)],
                       w.device)
    planes = PlaneRounds.build(key, T, ENGINE_HPS, faults, async_, E,
                               w.device)
    fs, abuf = planes.init(K * N, K * E, d, w.device, state.zm.dtype)
    ps_up = None if faults is None else torch.from_numpy(
        ps_alive_rounds(key, T, faults, engine=ENGINE_HPS)).to(w.device)

    def ratios_k(st):
        return sparse_ratios(st).view(K, N, d)

    ys = []
    for t in range(T):
        # --- consensus (Alg. 1 lines 3-12) ---
        fs, awake = planes.step(t, fs, K * N)
        mask = round_mask(Key(keys.k0[t], keys.k1[t]), t, E, drop, B,
                          planes.faults, fs, rt.src, rt.dst)
        st, abuf = plane_step(state, mask, rt.src, rt.dst, rt.valid,
                              backend, share=share, offsets=rt.offsets,
                              fs=fs, awake=awake, abuf=abuf, planes=planes,
                              policy=policy)
        # --- PS fusion every Γ (lines 13-21), per scenario ---
        zm = st.zm.view(K, N, d + 1)
        do_fusion = (t + 1) % gamma == 0
        if ps_up is not None:
            # PS crash: the round's fusion is skipped
            do_fusion = do_fusion & ps_up[t]
        live = None if fs is None else fs.node_live.view(K, N)
        state = st._replace(zm=torch.where(
            do_fusion[:, None, None],
            _fuse(zm, rep, M, F, live, None if policy is None else ac),
            zm).view(K * N, d + 1))
        if store == "trajectory":
            ys.append(ratios_k(state))
        elif store == "gap":
            ys.append((ratios_k(state) - target).abs().amax(dim=(1, 2)))
    if store == "trajectory":
        ratio = (torch.stack(ys, dim=1) if ys
                 else w.new_zeros((K, 0, N, d)))
        gap = (ratio - target).abs().amax(dim=(2, 3))
    else:
        ratio = ratios_k(state)
        gap = ((torch.stack(ys, dim=1) if ys else w.new_zeros((K, 0)))
               if store == "gap"
               else (ratio - target).abs().amax(dim=(1, 2)))
    if rt.drop_prob.ndim == 0:
        ratio, gap = ratio[0], gap[0]
    return state, (ratio, gap)


def run_hps_runtime(
    w,
    rt: HPSRuntime,
    T: int,
    seed: int = 0,
    *,
    F: int = 0,
    plan: ExecutionPlan | None = None,
    device=None,
) -> HPSResult:
    """Run Algorithm 1 on a prebuilt :class:`HPSRuntime`.

    ``seed`` drives the per-round link masks on the ``hps_stream_fold``
    domain; ``F > 0`` swaps the PS average for the trimmed-pool rule.
    ``plan.store=None`` means ``"trajectory"``; ``plan.dst_sorted=True``
    asserts a dst-sorted edge index and is checked against the runtime.
    ``plan.faults`` and ``plan.async_`` run the fault and async planes
    (:func:`_hps_scan_core`); a degenerate async model runs the
    synchronous loop. ``plan.policy`` is the precision policy (state at
    its storage dtype, K1 on half storage on the card). ``device=None``
    means the card, and raises where there is none; pass ``device="cpu"``
    to run the plain PyTorch path on the CPU.
    """
    plan = check_plan(plan, "run_hps_runtime",
                      ("backend", "store", "dst_sorted", "faults", "async_",
                       "policy"))
    store = "trajectory" if plan.store is None else plan.store
    if store not in HPS_STORES:
        raise ValueError(f"store must be one of {HPS_STORES}, got {store!r}")
    if plan.dst_sorted and rt.offsets is None:
        raise ValueError("plan.dst_sorted=True but the runtime's edge index "
                         "is not dst-sorted")
    dev = resolve_device(device)
    final, (ratio, gap) = _hps_scan_core(
        prng_key(seed), rt.to(dev),
        torch.as_tensor(w, dtype=torch.float32, device=dev),
        T=T, store=store, backend=plan.backend, F=F, faults=plan.faults,
        async_=None if is_degenerate_async(plan.async_) else plan.async_,
        policy=plan.policy)
    return HPSResult(ratio=ratio, final_state=final, gap=gap)


def run_hps(
    w,
    cfg: HPSConfig,
    T: int,
    seed: int = 0,
    *,
    F: int = 0,
    plan: ExecutionPlan | None = None,
    device=None,
) -> HPSResult:
    """Run HPS for T iterations on an :class:`HPSConfig` scenario (whose
    edge index is always dst-sorted); see :func:`run_hps_runtime`."""
    plan = check_plan(plan, "run_hps",
                      ("backend", "store", "faults", "async_", "policy"))
    return run_hps_runtime(w, make_hps_runtime(cfg), T, seed=seed, F=F,
                           plan=plan.replace(dst_sorted=True), device=device)


def run_hps_dense(
    w,
    cfg: HPSConfig,
    T: int,
    seed: int = 0,
    *,
    device=None,
) -> tuple[PushSumState, torch.Tensor]:
    """The dense reference: (N, N) masks, O(N^2 d) relay state, for small
    N only. It draws the same per-round (E,) masks as :func:`run_hps` at
    the same seed (over the dst-sorted edge index, on the
    ``hps_stream_fold`` domain) and scatters them to (N, N), so the two
    agree to float32 reduction order. Returns the final dense state and
    the (T, N, d) ratio trajectory."""
    dev = resolve_device(device)
    el = cfg.edge_index()
    src = torch.from_numpy(el.src).long().to(dev)
    dst = torch.from_numpy(el.dst).long().to(dev)
    n = cfg.topo.N
    adj = cfg.adj().to(dev)
    rep_mask = cfg.rep_mask().to(dev)
    drop = torch.tensor(cfg.drop_prob, dtype=torch.float32, device=dev)
    B = torch.tensor(cfg.B, dtype=torch.int32, device=dev)
    key = prng_key(seed)
    state = init_state(torch.as_tensor(w, dtype=torch.float32, device=dev))
    traj = []
    for t in range(T):
        mask_e = step_edge_mask(key, t, el.E, drop, B,
                                fold_t=hps_stream_fold(t))
        mask = torch.zeros((n, n), dtype=torch.bool, device=dev)
        mask[src, dst] = mask_e
        state = hps_step(state, mask, adj, rep_mask, cfg.topo.M,
                         (t + 1) % cfg.gamma_period == 0)
        traj.append(ratios(state))
    return state, _frames(traj, state.z)


def theorem1_bound(cfg: HPSConfig, w, t: int) -> float:
    """The right side of Theorem 1 at iteration t (loose, by the paper's own
    Remark 3)."""
    topo = cfg.topo
    M = topo.M
    contraction = topo.min_beta() ** (2 * topo.d_star() * cfg.B)
    gamma = 1.0 - contraction / (4.0 * M * M)
    norm_sum = float(np.linalg.norm(np.asarray(w), axis=1).sum())
    lead = 4.0 * M * M * norm_sum / (contraction * topo.N)
    return lead * gamma ** max(t // (2 * cfg.gamma_period) - 1, 0)
