"""Robust gradient aggregation, the paper's algorithms as training
features: the port of ``repro.distributed.aggregation``.

The reference maps the paper onto a TPU mesh: an agent is a data-parallel
worker, a sub-network a pod, a gossip edge a ``ppermute``, and each
aggregator runs inside ``shard_map`` on one worker's gradient, reaching the
others through collectives. Here every worker lives on one card, so each
aggregator takes all workers' gradients at once, ``grads`` (W, D) float32
(worker ``w = pod * per_pod + data`` in row w, every leaf of its gradient
flattened and concatenated along D), and returns each worker's aggregate,
(W, D) float32. An aggregate every worker shares comes back as a stride-0
``expand`` of one (D,) row. The reference's per-leaf aggregation is
column-wise, so one call over the concatenation is the same computation:
the trainer casts each leaf's columns back to the leaf's dtype, as every
reference aggregator does last.

Aggregators
-----------
``mean``         — the plain mean over workers (the non-robust baseline).
``pushsum``      — Algorithm 1 on each pod's directed ring with simulated
                   packet drops (Bernoulli per sender and round, forced
                   every B rounds), cumulative sigma/rho recovery, and the
                   fusion of the pods' first workers every Γ rounds; each
                   worker keeps its own z/m.
``pushsum_sparse`` — Algorithm 1 on a random strongly connected digraph of
                   all workers through the port's edge-list core
                   (kernel K1 on the card); each worker keeps its row.
``trimmed_mean`` — Algorithm 2's filter, coordinate-wise over all W
                   workers (kernel K4 on the card, one launch).
``trimmed_mean_sharded`` — the reference's all-to-all form of the same
                   trim; on one card its only numeric effect is the
                   rounding of the gradients (and of the result) to
                   ``comm_dtype``.
``hierarchical_trim`` — the trim within each pod, then across the pod
                   estimates (F there only when n_pods >= 2F + 1): one K4
                   launch per pod and one across pods.

Random draws use the reference's keys bit for bit through
:mod:`repro_torch.core.prng`, so the drop masks equal the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.graphs import edge_list, random_strongly_connected, sort_by_dst
from ..core.prng import Key, fold_in, threefry2x32
from ..core.pushsum import (init_sparse_state, sparse_pushsum_step,
                            sparse_ratios, step_edge_mask)
from ..kernels.dispatch import resolve_backend
from ..kernels.trimmed_mean import trimmed_mean

__all__ = ["AggregatorConfig", "WorkerLayout", "AGGREGATORS", "agg_mean",
           "agg_pushsum", "agg_pushsum_sparse", "agg_trimmed",
           "agg_trimmed_sharded", "agg_hierarchical_trim"]

# columns per pass of the sparse gossip: bounds its (E, cols) edge state
GOSSIP_COLS = 1 << 24


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """The reference's knobs. ``trim_backend`` and ``pushsum_backend`` take
    the port's routes ``"auto" | "torch" | "cuda"``; both default to
    ``"auto"`` (the kernel on the card), where the reference's
    ``trim_backend`` defaults to ``"xla"``, its plain path, which here
    would keep the card off K4. The reference's ``trim_chunk``, which it
    never reads, is left out."""

    kind: str = "mean"
    # pushsum knobs
    gossip_rounds: int = 16
    gamma_period: int = 4           # PS fusion every Γ rounds
    drop_prob: float = 0.1          # simulated packet-drop probability
    B: int = 2                      # every link delivers >= once per B rounds
    # pushsum_sparse knobs: random Hamiltonian cycle + Bernoulli extra edges
    graph_extra_edge_prob: float = 0.25
    graph_seed: int = 0
    pushsum_backend: str = "auto"
    # byzantine knobs
    F: int = 1                      # trim F from each extreme
    trim_backend: str = "auto"
    comm_dtype: str = "float32"     # wire dtype of the sharded trim


class WorkerLayout(NamedTuple):
    """The (pod, data) worker grid of the reference's mesh."""

    n_pods: int
    per_pod: int

    @property
    def n_workers(self) -> int:
        return self.n_pods * self.per_pod


def _shared(row: torch.Tensor, W: int) -> torch.Tensor:
    return row.expand(W, row.shape[0])


def _uniform_scalar(key: Key) -> float:
    """``jax.random.uniform(key, ())``, computed on the host."""
    b0, b1 = threefry2x32(key.k0, key.k1, 0, 0)
    bits = np.array([((b0 ^ b1) >> 9) | 0x3F800000], np.uint32)
    return float(bits.view(np.float32)[0] - np.float32(1.0))


# ---------------------------------------------------------------------------
# mean (baseline)
# ---------------------------------------------------------------------------

def agg_mean(grads: torch.Tensor, cfg: AggregatorConfig,
             layout: WorkerLayout, key: Key) -> torch.Tensor:
    return _shared(grads.mean(dim=0), grads.shape[0])


# ---------------------------------------------------------------------------
# robust push-sum over each pod's ring (Algorithm 1)
# ---------------------------------------------------------------------------

def agg_pushsum(grads: torch.Tensor, cfg: AggregatorConfig,
                layout: WorkerLayout, key: Key) -> torch.Tensor:
    """Fast robust push-sum on the directed ring i -> i+1 of each pod
    (out-degree 1, share 1/2), cumulative sigma/rho drop recovery, and
    hierarchical fusion of the pods' first workers every Γ rounds.

    A dropped message leaves the receiver's rho as it was (the reference
    sends NaN and keeps the old rho where it reads one)."""
    P, Wd = layout
    W, D = grads.shape
    dev = grads.device
    z = grads.float().reshape(P, Wd, D).clone()
    m = torch.ones((P, Wd, 1), dtype=torch.float32, device=dev)
    sig = torch.zeros_like(z)
    sig_m = torch.zeros_like(m)
    rho = torch.zeros_like(z)
    rho_m = torch.zeros_like(m)
    for t in range(cfg.gossip_rounds):
        # each sender's link: a uniform from fold_in(fold_in(key, t), w),
        # w = didx + Wd * pidx, forced up every B rounds
        kt = fold_in(key, t)
        up = [_uniform_scalar(fold_in(kt, w)) >= cfg.drop_prob
              or t % cfg.B == cfg.B - 1 for w in range(W)]
        up = torch.tensor(up, device=dev).reshape(P, Wd, 1)
        sig = sig + z * 0.5
        sig_m = sig_m + m * 0.5
        # receiver i hears sender i-1 of its pod; it keeps rho on a drop
        ok = torch.roll(up, 1, dims=1)
        rho_new = torch.where(ok, torch.roll(sig, 1, dims=1), rho)
        rho_m_new = torch.where(ok, torch.roll(sig_m, 1, dims=1), rho_m)
        z = z * 0.5 + (rho_new - rho)
        m = m * 0.5 + (rho_m_new - rho_m)
        sig = sig + z * 0.5
        sig_m = sig_m + m * 0.5
        z = z * 0.5
        m = m * 0.5
        rho, rho_m = rho_new, rho_m_new
        if P > 1 and (t + 1) % cfg.gamma_period == 0:
            # the pods' representatives (data index 0) pool half their mass
            pooled = z[:, 0].sum(dim=0) / (2.0 * P)
            pooled_m = m[:, 0].sum(dim=0) / (2.0 * P)
            z[:, 0] = 0.5 * z[:, 0] + pooled
            m[:, 0] = 0.5 * m[:, 0] + pooled_m
    return (z / torch.clamp_min(m, 1e-12)).reshape(W, D)


# ---------------------------------------------------------------------------
# edge-list push-sum on a random worker digraph (Algorithm 1, sparse core)
# ---------------------------------------------------------------------------

def agg_pushsum_sparse(grads: torch.Tensor, cfg: AggregatorConfig,
                       layout: WorkerLayout, key: Key) -> torch.Tensor:
    """Robust push-sum over a random strongly connected digraph of all
    workers (pods flattened), the reference's ``gossip_rounds`` of
    ``sparse_pushsum_step`` with the same masks, on the dst-sorted edge
    index the CUDA edge scatter (K1) walks. Columns are gossiped in passes
    of at most 2^24 (each column's consensus is independent of the
    others)."""
    W, D = grads.shape
    dev = grads.device
    adj = random_strongly_connected(
        W, cfg.graph_extra_edge_prob, np.random.default_rng(cfg.graph_seed))
    el, _, _, offsets = sort_by_dst(edge_list(adj), return_offsets=True)
    src = torch.from_numpy(el.src).to(dev)
    dst = torch.from_numpy(el.dst).to(dev)
    valid = torch.from_numpy(el.valid).to(dev)
    offsets = torch.from_numpy(offsets).to(dev)
    drop = torch.tensor(cfg.drop_prob, dtype=torch.float32, device=dev)
    B = torch.tensor(cfg.B, dtype=torch.int64, device=dev)
    masks = [step_edge_mask(key, t, el.E, drop, B)
             for t in range(cfg.gossip_rounds)]
    out = torch.empty((W, D), dtype=torch.float32, device=dev)
    for c0 in range(0, D, GOSSIP_COLS):
        state = init_sparse_state(grads[:, c0:c0 + GOSSIP_COLS].float(),
                                  el.E)
        for mask in masks:
            state = sparse_pushsum_step(state, mask, src, dst, valid,
                                        cfg.pushsum_backend, offsets=offsets)
        out[:, c0:c0 + GOSSIP_COLS] = sparse_ratios(state)
    return out


# ---------------------------------------------------------------------------
# coordinate-wise trimmed mean (Algorithm 2's filter over workers)
# ---------------------------------------------------------------------------

def agg_trimmed(grads: torch.Tensor, cfg: AggregatorConfig,
                layout: WorkerLayout, key: Key) -> torch.Tensor:
    """Trim F largest/smallest per coordinate across all workers (pods
    flattened), then average: tolerates any F Byzantine workers."""
    return _shared(trimmed_mean(grads.float(), cfg.F, cfg.trim_backend),
                   grads.shape[0])


def agg_hierarchical_trim(grads: torch.Tensor, cfg: AggregatorConfig,
                          layout: WorkerLayout, key: Key) -> torch.Tensor:
    """Two-level Algorithm 2: the trim within each pod (sub-network
    consensus), then the trimmed fusion of the pod estimates. With
    n_pods <= 2F the cross-pod trim is a mean: the paper's Assumption 5
    (2F + 1 sub-networks are needed to trim)."""
    P, Wd = layout
    W, D = grads.shape
    g = grads.float()
    if P == 1:
        return _shared(trimmed_mean(g, cfg.F, cfg.trim_backend), W)
    pod_est = torch.empty((P, D), dtype=torch.float32, device=g.device)
    in_place = resolve_backend(cfg.trim_backend, g) == "cuda"
    for p in range(P):
        rows = g[p * Wd:(p + 1) * Wd]
        if in_place:                      # K4 writes the pod's row itself
            trimmed_mean(rows, cfg.F, cfg.trim_backend, out=pod_est[p])
        else:
            pod_est[p] = trimmed_mean(rows, cfg.F, cfg.trim_backend)
    f_cross = cfg.F if P >= 2 * cfg.F + 1 else 0
    return _shared(trimmed_mean(pod_est, f_cross, cfg.trim_backend), W)


_WIRE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
         "float16": torch.float16}


def agg_trimmed_sharded(grads: torch.Tensor, cfg: AggregatorConfig,
                        layout: WorkerLayout, key: Key) -> torch.Tensor:
    """The reference's bandwidth-saving form of ``trimmed_mean`` (an
    all-to-all of coordinate stripes, a local trim, an all-gather). Every
    worker is on this card, so there is nothing to exchange: what is left
    is its arithmetic, the trim of the gradients rounded to
    ``comm_dtype``, the result rounded to it again."""
    wire = _WIRE[cfg.comm_dtype]
    x = grads.to(wire).float()
    out = trimmed_mean(x, cfg.F, cfg.trim_backend)
    return _shared(out.to(wire).float(), grads.shape[0])


AGGREGATORS: dict[str, Callable] = {
    "mean": agg_mean,
    "pushsum": agg_pushsum,
    "pushsum_sparse": agg_pushsum_sparse,
    "trimmed_mean": agg_trimmed,
    "trimmed_mean_sharded": agg_trimmed_sharded,
    "hierarchical_trim": agg_hierarchical_trim,
}
