"""The fault plane — bursty links, agent churn, parameter-server crash.

The port of ``repro.core.faults``. The paper's links drop packets i.i.d.
Bernoulli; this plane generalises that draw in three directions and keeps
the degenerate case bit-identical:

* **bursty drops** — a two-state Gilbert–Elliott chain per edge: a good
  edge drops at the engine's ``drop_prob``, a bad one at ``drop_bad``;
  the chain moves good -> bad with ``p_gb`` and bad -> good with
  ``p_bg``. A bad edge is exempt from the B-window forcing (a burst *is* a
  violation of the window). ``p_gb = 0`` never leaves the good state and
  gives the engine's Bernoulli mask draw for draw, because the drop
  uniform stays on the engine's own link stream;
* **churn** — an (N,) liveness mask: a dead agent's edges are down in
  both directions and its node state is frozen (:func:`freeze`), so it
  rejoins stale and the push-sum mass invariant holds through leave and
  rejoin;
* **PS crash** — one coin a round: while the parameter server is down
  the Γ-period fusion is skipped.

:class:`FaultModel` holds the six knobs as float32 tensors: 0-d for one
scenario, (K,) for a grid of K (a grid's fault axis). :class:`FaultState`
is the per-round realisation, O(E) + O(N). The state of K stacked
scenarios is flat — (K·E,) edge bits, (K·N,) liveness — in the
block-diagonal layout of :mod:`repro_torch.core.sweeps`.

Fault draws fold into the key in their own band, ``-(12 t + 3 engine +
stream) - 2^21`` as a 32-bit word (:func:`fault_stream_fold`), below the
HPS ``~t`` band and apart from every nonnegative engine stream. A draw
takes the reference's element count for its scenario (threefry has no
prefix property): ``step_faults`` one uniform an edge and one an agent,
``step_faults_nbr`` one flat ``2·N·deg_max`` draw split into two planes,
``ps_alive`` the first element of a one-element draw. The engines fold
the keys of every round on the host before their loop
(:func:`repro_torch.core.prng.fold_rounds`) and advance the state with
:func:`advance_faults` / :func:`advance_faults_nbr`; the PS coins of all
rounds are drawn on the host at once (:func:`ps_alive_rounds`), so no
round reads anything back from the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .prng import Key, fold_in, fold_rounds, threefry2x32, uniform

__all__ = [
    "ENGINE_PUSHSUM",
    "ENGINE_SOCIAL",
    "ENGINE_HPS",
    "ENGINE_BYZANTINE",
    "FAULT_EDGE",
    "FAULT_CHURN",
    "FAULT_PS",
    "FAULT_DOMAIN_BASE",
    "FaultModel",
    "FaultState",
    "fault_stream_fold",
    "make_fault_model",
    "gilbert_elliott_model",
    "stack_fault_models",
    "init_fault_state",
    "step_faults",
    "step_faults_nbr",
    "advance_faults",
    "advance_faults_nbr",
    "faulty_edge_mask",
    "ps_alive",
    "ps_alive_rounds",
    "freeze",
]

N_ENGINES = 4
ENGINE_PUSHSUM, ENGINE_SOCIAL, ENGINE_HPS, ENGINE_BYZANTINE = range(N_ENGINES)

N_FAULT_STREAMS = 3
FAULT_EDGE, FAULT_CHURN, FAULT_PS = range(N_FAULT_STREAMS)

FAULT_DOMAIN_BASE = 1 << 21

_STRIDE = N_ENGINES * N_FAULT_STREAMS


def fault_stream_fold(t: int, engine: int, stream: int) -> np.int32:
    """Fold-in value of fault ``stream`` of ``engine`` at iteration ``t``:
    ``-(12 t + 3 engine + stream) - 2^21``, pinned to ``np.int32`` as the
    reference pins it, so the word folded is the same 32 bits."""
    slot = int(engine) * N_FAULT_STREAMS + int(stream)
    return np.int32(-(int(t) * _STRIDE + slot) - FAULT_DOMAIN_BASE)


class FaultModel(NamedTuple):
    """The fault knobs as float32 tensors, 0-d for one scenario or (K,)
    for K (:func:`stack_fault_models`). :func:`make_fault_model`'s
    defaults are degenerate: no edge turns bad, no agent leaves, the PS
    never crashes."""

    p_gb: torch.Tensor           # P(good -> bad) per edge per round
    p_bg: torch.Tensor           # P(bad -> good); mean burst 1 / p_bg
    drop_bad: torch.Tensor       # drop probability while bad
    leave_prob: torch.Tensor     # P(live agent leaves) per round
    join_prob: torch.Tensor      # P(dead agent rejoins) per round
    ps_crash_prob: torch.Tensor  # P(parameter server down) per round

    def to(self, device) -> "FaultModel":
        return FaultModel(*(x.to(device) for x in self))


def make_fault_model(
    *,
    p_gb=0.0,
    p_bg=1.0,
    drop_bad=1.0,
    leave_prob=0.0,
    join_prob=1.0,
    ps_crash_prob=0.0,
) -> FaultModel:
    f = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    return FaultModel(p_gb=f(p_gb), p_bg=f(p_bg), drop_bad=f(drop_bad),
                      leave_prob=f(leave_prob), join_prob=f(join_prob),
                      ps_crash_prob=f(ps_crash_prob))


def gilbert_elliott_model(mean_burst_len: float, bad_frac: float, *,
                          drop_bad: float = 1.0, **kw) -> FaultModel:
    """The Gilbert–Elliott chain by its stationary behaviour: bursts last
    ``mean_burst_len`` rounds on average and an edge is bad a
    ``bad_frac`` share of the time (the reference's float64 arithmetic,
    then float32)."""
    if mean_burst_len < 1.0:
        raise ValueError(f"mean_burst_len must be >= 1, got {mean_burst_len}")
    if not 0.0 <= bad_frac < 1.0:
        raise ValueError(f"bad_frac must be in [0, 1), got {bad_frac}")
    p_bg = 1.0 / mean_burst_len
    p_gb = bad_frac * p_bg / (1.0 - bad_frac)
    return make_fault_model(p_gb=p_gb, p_bg=p_bg, drop_bad=drop_bad, **kw)


def stack_fault_models(models) -> FaultModel:
    """Fault models of one scenario each -> one with (K,) leaves."""
    return FaultModel(*(torch.stack([m[i].reshape(()) for m in models])
                        for i in range(len(FaultModel._fields))))


class FaultState(NamedTuple):
    """Per-round realisation: O(E) + O(N)."""

    edge_bad: torch.Tensor   # (E,) or (N, deg_max) bool — Gilbert–Elliott state
    node_live: torch.Tensor  # (N,) bool — churn liveness


def init_fault_state(n_nodes: int, edge_shape, device=None) -> FaultState:
    """All edges good, all agents live. ``edge_shape`` is an edge count or
    the Byzantine (N, deg_max) slot shape."""
    shape = (edge_shape,) if isinstance(edge_shape, int) else tuple(edge_shape)
    return FaultState(
        edge_bad=torch.zeros(shape, dtype=torch.bool, device=device),
        node_live=torch.ones((n_nodes,), dtype=torch.bool, device=device))


def _n_keys(key: Key) -> int:
    """The number of keys in ``key``: 1 for one key (Python ints), K for
    K numpy words or a (K, 1) tensor of keys."""
    k0 = key.k0
    if isinstance(k0, (int, np.integer)):
        return 1
    return int(k0.shape[0]) if k0.ndim else 1


def _rows(x, like: torch.Tensor) -> torch.Tensor:
    """A knob (0-d or (K,)) as a (1 | K, 1) column on ``like``'s device."""
    return torch.as_tensor(x, device=like.device).reshape(-1, 1)


def _chain(bad: torch.Tensor, u: torch.Tensor, fm: FaultModel):
    """One Gilbert–Elliott step of (K, n) edge bits on (K, n) uniforms."""
    return torch.where(bad, u >= _rows(fm.p_bg, u), u < _rows(fm.p_gb, u))


def _churn(kc: Key, fm: FaultModel, live: torch.Tensor, K: int):
    """One churn step of the (K·N,) liveness on the churn key(s)."""
    u = uniform(kc, live.numel() // K, live.device).reshape(K, -1)
    return torch.where(live.view(K, -1), u >= _rows(fm.leave_prob, u),
                       u < _rows(fm.join_prob, u)).reshape(-1)


def advance_faults(ke: Key, kc: Key, fm: FaultModel,
                   fs: FaultState) -> FaultState:
    """:func:`step_faults` from the round's folded edge and churn keys
    (one key, or K keys whose state is stacked flat)."""
    K = _n_keys(ke)
    bad = fs.edge_bad.view(K, -1)
    u = uniform(ke, bad.shape[1], bad.device).reshape(K, -1)
    return FaultState(edge_bad=_chain(bad, u, fm).reshape(fs.edge_bad.shape),
                      node_live=_churn(kc, fm, fs.node_live, K))


def step_faults(key: Key, t: int, fm: FaultModel, fs: FaultState, *,
                engine: int) -> FaultState:
    """Advance the Gilbert–Elliott edge chain and the churn mask one round
    on the engine's FAULT_EDGE / FAULT_CHURN streams (unsharded)."""
    return advance_faults(
        fold_in(key, fault_stream_fold(t, engine, FAULT_EDGE)),
        fold_in(key, fault_stream_fold(t, engine, FAULT_CHURN)), fm, fs)


def advance_faults_nbr(ke: Key, kc: Key, fm: FaultModel, fs: FaultState):
    """:func:`step_faults_nbr` from the round's folded keys -> (state,
    drop). The edge state is the (N, deg_max) slot table, or K tables
    stacked to (K·N, deg_max): each scenario draws one flat 2·N·deg_max
    uniform, plane 0 for the chain and plane 1 for the drop coin."""
    K = _n_keys(ke)
    bad = fs.edge_bad.reshape(K, -1)
    u2 = uniform(ke, 2 * bad.shape[1], bad.device).reshape(K, 2, -1)
    edge_bad = _chain(bad, u2[:, 0], fm)
    drop = edge_bad & (u2[:, 1] < _rows(fm.drop_bad, u2))
    shape = fs.edge_bad.shape
    return (FaultState(edge_bad=edge_bad.reshape(shape),
                       node_live=_churn(kc, fm, fs.node_live, K)),
            drop.reshape(shape))


def step_faults_nbr(key: Key, t: int, fm: FaultModel, fs: FaultState, *,
                    engine: int):
    """The neighbor-slot variant of :func:`step_faults` -> (state, drop):
    the Byzantine gossip has no baseline drop, so a slot drops only while
    bad, on plane 1's coin (``< drop_bad``)."""
    return advance_faults_nbr(
        fold_in(key, fault_stream_fold(t, engine, FAULT_EDGE)),
        fold_in(key, fault_stream_fold(t, engine, FAULT_CHURN)), fm, fs)


def faulty_edge_mask(u: torch.Tensor, t: int, fm: FaultModel,
                     fs: FaultState, src: torch.Tensor, dst: torch.Tensor,
                     drop_prob, B) -> torch.Tensor:
    """Per-edge up/down mask under the fault plane -> flat (E,) or (K·E,).

    ``u`` is the engine's own link uniform, (E,) or (K, E) for K stacked
    scenarios with (K,) ``drop_prob`` and ``B``; with an all-good,
    all-live state the mask is :func:`repro_torch.core.pushsum.edge_mask`'s
    bit for bit. Bad edges drop at ``drop_bad`` and are not forced by the
    B-window; an edge with a dead end is down."""
    u = u.reshape(-1, u.shape[-1])
    bad = fs.edge_bad.view(u.shape)
    p_eff = torch.where(bad, _rows(fm.drop_bad, u), _rows(drop_prob, u))
    forced = ((t % _rows(B, u)) == (_rows(B, u) - 1)) & ~bad
    mask = ((u >= p_eff) | forced).reshape(-1)
    return mask & fs.node_live[src] & fs.node_live[dst]


def _uniform0(k0, k1) -> np.ndarray:
    """The first float32 of ``jax.random.uniform`` for numpy key words."""
    b0, b1 = threefry2x32(k0, k1, 0, 0)
    bits = (((b0 ^ b1) >> 9) | 0x3F800000).astype(np.uint32)
    return bits.view(np.float32) - np.float32(1.0)


def ps_alive(key: Key, t: int, fm: FaultModel, *, engine: int,
             device=None) -> torch.Tensor:
    """Is the parameter server up this round (FAULT_PS stream)? A 0-d
    bool tensor for one key, (K,) for K keys."""
    k = fold_in(key, fault_stream_fold(t, engine, FAULT_PS))
    dev = fm.ps_crash_prob.device if device is None else device
    return uniform(k, 1, dev)[..., 0] >= fm.ps_crash_prob.to(dev)


def ps_alive_rounds(key: Key, T: int, fm: FaultModel, *,
                    engine: int) -> np.ndarray:
    """:func:`ps_alive` of every round and key at once, on the host ->
    (T, K) bool numpy. Reads the crash probabilities once."""
    words = fold_rounds(key, [fault_stream_fold(t, engine, FAULT_PS)
                              for t in range(T)], None)
    p = fm.ps_crash_prob.detach().cpu().numpy().astype(np.float32)
    return _uniform0(*words) >= p.reshape(1, -1)


def freeze(live: torch.Tensor, new: torch.Tensor,
           old: torch.Tensor) -> torch.Tensor:
    """``where(live, new, old)`` for (N,) or (N, d) node state: a dead
    (or asleep) agent's state is carried unchanged."""
    if new.dim() == live.dim() + 1:
        return torch.where(live[:, None], new, old)
    return torch.where(live, new, old)
