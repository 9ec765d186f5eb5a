"""Non-Bayesian learning over packet-dropping links — Algorithm 3 / Theorem 2.

The port of ``repro.core.social`` on its single-device path. Each
iteration interleaves one push-sum round on the per-hypothesis
log-likelihood accumulator ``z`` (N, m) and the mass ``m`` (N,) with the
local innovation ``z += log l(s_t | .)`` and the dual-averaging belief
``mu_j = softmax(z_j / m_j)``, in Algorithm 3's order: consensus (lines
4-12), innovation (13-15), belief (16), PS fusion every Γ (17-22).

The two per-iteration halves run through the port's kernels:

* consensus — :func:`repro_torch.core.pushsum.sparse_pushsum_step`, whose
  delivery is the CUDA edge scatter over the runtime's dst-sorted index;
* innovation + belief — :func:`repro_torch.kernels.social_innov.
  innovation_step`, one CUDA thread per agent.

The reference's ``lax.scan`` is a Python loop over ``t`` here. The loop
reads nothing back to the host: ``drop_prob``, ``gamma`` and ``B`` stay
device tensors and the fusion round is selected with ``torch.where``,
and the PRNG keys (:mod:`repro_torch.core.prng`) are folded on the host
for every round before the loop, in the reference's disjoint domains
``2t + stream``, so the link masks and signals are the reference's bit
for bit. A grid of scenarios (:mod:`repro_torch.core.sweeps`) runs
through the same loop as one block-diagonal graph.

The fault and async planes (:mod:`.faults`, :mod:`.asyncrony`) run in the
same loop: a dead or asleep agent gossips nothing and observes no signal
(its accumulator and belief stay frozen), dead representatives leave the
fusion, and a crashed PS skips the round's fusion.

The precision policy (``plan.policy``, :mod:`.precision`) stores the
consensus state and the carried belief at its storage dtype, so under a
half policy no float32 (N, m) value persists across rounds; the
innovation and the belief run in its accum dtype (K2 on half storage on
the card), and the beliefs and log-ratios come out float32.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.social_innov import innovation_step
from .asyncrony import AsyncModel, is_degenerate_async
from .faults import ENGINE_SOCIAL, FaultModel, freeze, ps_alive_rounds
from .graphs import EdgeList
from .hps import HPSConfig, _fuse
from .plan import ExecutionPlan, check_plan, resolve_device
from .precision import policy_dtypes
from .prng import Key, fold_rounds, prng_key, uniform
from .pushsum import (
    PlaneRounds,
    SparsePushSumState,
    _out_degree,
    edge_index_tensors,
    init_sparse_state,
    plane_step,
    round_mask,
)
from .signals import SignalModel, pairwise_kl

__all__ = [
    "SocialLearningResult",
    "SocialRuntime",
    "SOCIAL_STORES",
    "N_SOCIAL_STREAMS",
    "STREAM_LINK",
    "STREAM_SIGNAL",
    "social_stream_fold",
    "kl_dual_averaging_update",
    "make_social_runtime",
    "social_runtime_from_edge_list",
    "run_social_learning",
    "run_social_runtime",
    "theorem2_rate",
]

SOCIAL_STORES = ("trajectory", "log_ratio", "final")

# Belief floor for the log-ratio: the smallest NORMAL fp32. A subnormal
# floor (1e-38) is flushed to zero by some backends, which turned a fully
# converged wrong-hypothesis belief into log(0) and a NaN ratio.
_MU_FLOOR = float(np.finfo(np.float32).tiny)

N_SOCIAL_STREAMS = 2
STREAM_LINK, STREAM_SIGNAL = range(N_SOCIAL_STREAMS)


def social_stream_fold(t: int, stream: int) -> int:
    """Fold-in value of ``stream`` at iteration ``t`` — injective over
    (t, stream), so the link and signal streams never collide."""
    return t * N_SOCIAL_STREAMS + stream


class SocialLearningResult(NamedTuple):
    """Engine output; shapes depend on the store.

    ``"trajectory"``: ``beliefs`` (T, N, m) and ``log_ratio`` (T, N, m),
    log mu(theta)/mu(theta*). ``"log_ratio"``: final ``beliefs`` (N, m) and
    the (T,) worst-case curve max_{j, theta != theta*} of the log ratio.
    ``"final"``: both final-step only, (N, m) each.
    """

    beliefs: torch.Tensor
    final_state: SparsePushSumState
    log_ratio: torch.Tensor

    def to_numpy(self) -> tuple[np.ndarray, dict[str, np.ndarray], np.ndarray]:
        return (self.beliefs.cpu().numpy(), self.final_state.to_numpy(),
                self.log_ratio.cpu().numpy())


class SocialRuntime(NamedTuple):
    """Everything the loop reads that can vary per scenario, as tensors.

    ``offsets`` is the hoisted (N+1,) int32 CSR offsets of ``dst`` for the
    CUDA edge scatter, or ``None`` when the edge index is not dst-sorted
    (the CUDA route then raises)."""

    src: torch.Tensor             # (E,) int32 sender per edge
    dst: torch.Tensor             # (E,) int32 receiver per edge
    valid: torch.Tensor           # (E,) bool — False on padding edges
    offsets: torch.Tensor | None  # (N+1,) int32 CSR offsets of dst
    rep_mask: torch.Tensor        # (N,) bool — designated representatives
    drop_prob: torch.Tensor       # () f32 per-link packet-drop probability
    gamma: torch.Tensor           # () i32 PS fusion period
    B: torch.Tensor               # () i32 link-reliability window

    def to(self, device) -> "SocialRuntime":
        return SocialRuntime(*(None if x is None else x.to(device)
                               for x in self))


def kl_dual_averaging_update(z: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The KL-proximal dual-averaging projection, closed form: softmax(z/m)
    for the uniform prior. z: (N, m_hyp), m: (N,)."""
    return torch.softmax(z / m.clamp_min(1e-30)[:, None], dim=-1)


def social_runtime_from_edge_list(
    el: EdgeList,
    rep_mask: np.ndarray,
    *,
    drop_prob: float,
    gamma_period: int,
    B: int = 1,
    e_max: int | None = None,
) -> SocialRuntime:
    """Build a :class:`SocialRuntime` (CPU tensors) from a sparse edge index.

    ``e_max`` pads the edge axis with inert ``valid=False`` edges whose
    ``dst = N - 1``, which keeps a sorted layout sorted. The CSR offsets
    are computed here, once, when the index is dst-sorted.
    """
    return SocialRuntime(
        *edge_index_tensors(el, e_max),
        rep_mask=torch.tensor(np.asarray(rep_mask, bool)),
        drop_prob=torch.tensor(drop_prob, dtype=torch.float32),
        gamma=torch.tensor(gamma_period, dtype=torch.int32),
        B=torch.tensor(B, dtype=torch.int32),
    )


def make_social_runtime(cfg: HPSConfig,
                        e_max: int | None = None) -> SocialRuntime:
    """Host-side set-up of one :class:`HPSConfig` scenario."""
    return social_runtime_from_edge_list(
        cfg.edge_index(),
        cfg.topo.rep_mask(),
        drop_prob=cfg.drop_prob,
        gamma_period=cfg.gamma_period,
        B=cfg.B,
        e_max=e_max,
    )


def _social_scan_core(
    mask_key: Key,
    sig_key: Key,
    rt: SocialRuntime,
    log_tables: torch.Tensor,  # (N, m, S) hoisted log-likelihood tables
    cdf: torch.Tensor,         # (N, S) hoisted truth-row inclusive cumsum
    *,
    truth: int,
    M: int,
    T: int,
    store: str,
    backend: str,
    faults: FaultModel | None = None,
    async_: AsyncModel | None = None,
    policy=None,
) -> tuple[SparsePushSumState, tuple[torch.Tensor, torch.Tensor]]:
    """Algorithm 3's loop over the runtime's tensors, all on one device.

    Returns ``(final_state, (beliefs, log_ratio))`` with the store-dependent
    shapes of :class:`SocialLearningResult`. A runtime of K scenarios
    stacked into one block-diagonal graph (:func:`repro_torch.core.sweeps.
    stack_runtimes`: K·N nodes, (K,) scalars) runs them in lockstep from
    keys of K words: one consensus step, one innovation step over the K·N
    agents (the tables repeated K times) and one fusion a round for all of
    them, and every output gains a leading K. A runtime with 0-d scalars
    is the one-scenario case and keeps the unbatched shapes.

    ``faults`` and ``async_`` (0-d or (K,) leaves) run the planes on
    ``ENGINE_SOCIAL``'s streams of the mask key: the link uniforms stay on
    the link fold, K2 runs over every agent and a dead or asleep agent's
    accumulator and belief then keep their previous values; dead
    representatives leave the fusion, and the PS coins of all T × K
    rounds are drawn on the host up front.

    ``policy``: the state and the carried belief at its storage dtype;
    K2 takes the storage-typed accumulator and mass, adds the signal's
    log-likelihood in the accum dtype and emits the belief in it; the
    fusion pools in accum. The trajectory store keeps each round's accum
    belief, the others the carried (storage) one, upcast to float32.
    """
    N, m = log_tables.shape[0], log_tables.shape[1]
    st, _, ac = policy_dtypes(policy)
    accum = None if policy is None else ac
    K = rt.drop_prob.numel()
    E = rt.src.shape[0] // K
    dev = log_tables.device
    drop, gamma, B = (x.reshape(-1) for x in (rt.drop_prob, rt.gamma, rt.B))
    rep = rt.rep_mask.view(K, N)
    # M as a device scalar: the live fusion divides by a tensor, and a
    # division by a Python scalar runs as a multiply by its reciprocal on
    # the card, so the degenerate fault model would differ by an ulp
    M = torch.tensor(float(M), device=dev)
    if K > 1:
        log_tables, cdf = log_tables.repeat(K, 1, 1), cdf.repeat(K, 1)
    # z accumulates per-hypothesis log-likelihood sums; init 0 (line 1)
    state = init_sparse_state(torch.zeros((K * N, m), device=dev), K * E,
                              policy)
    # loop invariants of the fixed edge index
    share = 1.0 / (_out_degree(rt.src, rt.valid, K * N) + 1.0)
    wrong_col = torch.arange(m, device=dev) == truth
    mask_keys = fold_rounds(
        mask_key, [social_stream_fold(t, STREAM_LINK) for t in range(T)],
        dev)
    sig_keys = fold_rounds(
        sig_key, [social_stream_fold(t, STREAM_SIGNAL) for t in range(T)],
        dev)
    planes = PlaneRounds.build(mask_key, T, ENGINE_SOCIAL, faults, async_,
                               E, dev)
    fs, abuf = planes.init(K * N, K * E, m, dev, st)
    ps_up = None if faults is None else torch.from_numpy(
        ps_alive_rounds(mask_key, T, faults, engine=ENGINE_SOCIAL)).to(dev)
    mu = torch.zeros((K * N, m), dtype=st, device=dev)   # carried belief
    ys = []
    for t in range(T):
        # --- consensus (lines 4-12) ---
        fs, awake = planes.step(t, fs, K * N)
        mask = round_mask(Key(mask_keys.k0[t], mask_keys.k1[t]), t, E, drop,
                          B, planes.faults, fs, rt.src, rt.dst)
        cs, abuf = plane_step(state, mask, rt.src, rt.dst, rt.valid,
                              backend, share=share, offsets=rt.offsets,
                              fs=fs, awake=awake, abuf=abuf, planes=planes,
                              policy=policy)
        # --- innovation + belief (lines 13-16), one fused pass ---
        u = uniform(Key(sig_keys.k0[t], sig_keys.k1[t]), N, dev)
        m_t = cs.m.contiguous()
        z_t = cs.z.contiguous()
        z, mu_t = innovation_step(z_t, m_t, u.reshape(-1), cdf, log_tables,
                                  backend, accum_dtype=accum)
        for on in (awake, None if fs is None else fs.node_live):
            if on is not None:
                # asleep or dead agents observe nothing: the accumulator
                # stays post-consensus and the belief stale
                z = freeze(on, z, z_t)
                mu_t = freeze(on, mu_t, mu.to(mu_t.dtype))
        mu = mu_t.to(st)
        # --- PS fusion every Γ (lines 17-22), applied post-innovation;
        # the emitted belief is the pre-fusion one ---
        zm = torch.cat([z, m_t[:, None]], dim=1).view(K, N, m + 1)
        do_fusion = (t + 1) % gamma == 0
        if ps_up is not None:
            do_fusion = do_fusion & ps_up[t]
        live = None if fs is None else fs.node_live.view(K, N)
        state = cs._replace(zm=torch.where(
            do_fusion[:, None, None],
            _fuse(zm, rep, M, live=live, accum_dtype=accum),
            zm).view(K * N, m + 1))
        if store == "trajectory":
            ys.append(mu_t.view(K, N, m))
        elif store == "log_ratio":
            log_mu = torch.log(mu_t.clamp_min(_MU_FLOOR))
            lr = log_mu - log_mu[:, truth : truth + 1]
            ys.append(lr.masked_fill(wrong_col, -torch.inf).view(
                K, N, m).amax(dim=(1, 2)))
    beliefs = mu.float().view(K, N, m)
    if store == "log_ratio":
        log_ratio = (torch.stack(ys, dim=1) if ys
                     else torch.zeros((K, 0), device=dev))
    else:
        if store == "trajectory":
            beliefs = (torch.stack(ys, dim=1) if ys
                       else torch.zeros((K, 0, N, m), device=dev))
        log_mu = torch.log(beliefs.clamp_min(_MU_FLOOR))
        log_ratio = log_mu - log_mu[..., truth : truth + 1]
    if rt.drop_prob.ndim == 0:
        beliefs, log_ratio = beliefs[0], log_ratio[0]
    return state, (beliefs, log_ratio)


def run_social_runtime(
    model: SignalModel,
    rt: SocialRuntime,
    M: int,
    T: int,
    seed: int = 0,
    signal_seed: int | None = None,
    *,
    plan: ExecutionPlan | None = None,
    device=None,
) -> SocialLearningResult:
    """Run Algorithm 3 on a prebuilt :class:`SocialRuntime`.

    ``seed`` drives the per-round link masks and ``signal_seed`` (default
    ``seed``) the private signals. ``plan.store=None`` means
    ``"trajectory"``; ``plan.dst_sorted=True`` asserts a dst-sorted edge
    index and is checked against the runtime. ``plan.faults`` and
    ``plan.async_`` run the fault and async planes; a degenerate async
    model runs the synchronous loop. ``plan.policy`` is the precision
    policy (K1 and K2 on half storage on the card). ``device=None`` means
    the card, and raises where there is none; pass ``device="cpu"`` to
    run the plain PyTorch path on the CPU.
    """
    plan = check_plan(plan, "run_social_runtime",
                      ("backend", "store", "dst_sorted", "faults", "async_",
                       "policy"))
    store = "trajectory" if plan.store is None else plan.store
    if store not in SOCIAL_STORES:
        raise ValueError(f"store must be one of {SOCIAL_STORES}, got {store!r}")
    if plan.dst_sorted and rt.offsets is None:
        raise ValueError("plan.dst_sorted=True but the runtime's edge index "
                         "is not dst-sorted")
    dev = resolve_device(device)
    tables = model.tables.to(dev, torch.float32)
    final, (beliefs, log_ratio) = _social_scan_core(
        prng_key(seed),
        prng_key(seed if signal_seed is None else signal_seed),
        rt.to(dev),
        torch.log(tables),
        torch.cumsum(tables[:, model.truth, :], dim=-1),
        truth=model.truth,
        M=M,
        T=T,
        store=store,
        backend=plan.backend,
        faults=plan.faults,
        async_=None if is_degenerate_async(plan.async_) else plan.async_,
        policy=plan.policy,
    )
    return SocialLearningResult(
        beliefs=beliefs, final_state=final, log_ratio=log_ratio)


def run_social_learning(
    model: SignalModel,
    cfg: HPSConfig,
    T: int,
    seed: int = 0,
    signal_seed: int = 100,
    *,
    plan: ExecutionPlan | None = None,
    device=None,
) -> SocialLearningResult:
    """Run Algorithm 3 for T iterations on an :class:`HPSConfig` scenario
    (whose edge index is always dst-sorted); see :func:`run_social_runtime`.
    """
    plan = check_plan(plan, "run_social_learning",
                      ("backend", "store", "faults", "async_", "policy"))
    return run_social_runtime(
        model, make_social_runtime(cfg), cfg.topo.M, T,
        seed=seed, signal_seed=signal_seed,
        plan=plan.replace(dst_sorted=True), device=device,
    )


def theorem2_rate(model: SignalModel, topo_N: int) -> np.ndarray:
    """The linear decay slopes -D_KL(theta*||theta)/N of Theorem 2, (m,)."""
    kl = pairwise_kl(model.tables.cpu().numpy())
    return -kl.sum(axis=0)[model.truth] / topo_N
