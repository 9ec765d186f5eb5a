"""The asynchronous plane — wake clocks and bounded stale buffers.

The port of ``repro.core.asyncrony``. Each agent wakes on its own clock,
one Bernoulli coin a tick (:func:`wake_mask`); an asleep agent's node
state is frozen as a churn-dead agent's is, it stages no message and
integrates no delivery. Messages ride a per-edge single-slot buffer
(:class:`AsyncBuffer`): an awake, live sender latches its freshly staged
cumulative into the slot of each of its out-edges (age 0), every other
slot ages by one tick, and a link delivers the slot when it is up, its
receiver is awake and the slot is at most ``staleness`` ticks old — the
sender may be asleep. The receiver integrates ``rho_new - rho`` of the
cumulative relay, so push-sum mass is conserved under any wake schedule.

The port keeps its joint layout: the buffer is one (E, d+1) snapshot of
the value and mass columns (as ``sigma_zm`` / ``rho_zm``) and an (E,)
int32 age. Delivery reads per-edge rows, so the engines send it through
K1 with the snapshot as its source rows and an identity source index
(:func:`repro_torch.core.pushsum.sparse_pushsum_step`).

``make_async_model()`` (wake 1, staleness 0) is degenerate: every agent
wakes, every slot is this tick's staged value, and the step is the
synchronous one bit for bit. The ``run_*`` entry points send a concrete
degenerate model to the synchronous loop itself
(:func:`is_degenerate_async`); a grid's (K,) model runs the buffered
loop. Wake coins fold into the key in their own band, ``-(4 t + engine)
- 2^25`` as a 32-bit word (:func:`async_stream_fold`), below the fault
band.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..statics import contracts as _contracts
from ..statics.dense import HORIZON_KEYS
from .faults import ENGINE_HPS, ENGINE_PUSHSUM, ENGINE_SOCIAL, N_ENGINES
from .prng import Key, fold_in, uniform

__all__ = [
    "ASYNC_DOMAIN_BASE",
    "AsyncModel",
    "AsyncBuffer",
    "async_stream_fold",
    "make_async_model",
    "stack_async_models",
    "init_async_buffer",
    "is_degenerate_async",
    "wake_mask",
    "wake_rows",
]

ASYNC_DOMAIN_BASE = 1 << 25


def async_stream_fold(t: int, engine: int) -> np.int32:
    """Fold-in value of ``engine``'s wake-coin stream at tick ``t``:
    ``-(4 t + engine) - 2^25``, pinned to ``np.int32`` as the reference
    pins it."""
    return np.int32(-(int(t) * N_ENGINES + int(engine)) - ASYNC_DOMAIN_BASE)


class AsyncModel(NamedTuple):
    """Wake rate and staleness bound: 0-d tensors for one scenario, (K,)
    for K (:func:`stack_async_models`)."""

    wake_prob: torch.Tensor  # float32 per-tick wake probability
    staleness: torch.Tensor  # int32 largest slot age that still delivers

    def to(self, device) -> "AsyncModel":
        return AsyncModel(*(x.to(device) for x in self))


def make_async_model(wake_prob=1.0, staleness=0) -> AsyncModel:
    return AsyncModel(
        wake_prob=torch.tensor(wake_prob, dtype=torch.float32),
        staleness=torch.tensor(staleness, dtype=torch.int32))


def stack_async_models(models) -> AsyncModel:
    """Async models of one scenario each -> one with (K,) leaves."""
    return AsyncModel(*(torch.stack([m[i].reshape(()) for m in models])
                        for i in range(len(AsyncModel._fields))))


def is_degenerate_async(am: AsyncModel | None) -> bool:
    """True iff ``am`` is None or one scenario's model with wake
    probability 1 and staleness 0; a stacked model is never degenerate
    here (it runs the buffered loop)."""
    if am is None:
        return True
    if am.wake_prob.numel() != 1 or am.wake_prob.dim() != 0:
        return False
    return float(am.wake_prob) >= 1.0 and int(am.staleness) == 0


class AsyncBuffer(NamedTuple):
    """Per-edge bounded buffer: the snapshot of the staged cumulative at
    the sender's last wake (value columns, then mass) and its age."""

    snap: torch.Tensor  # (E, d+1) float32
    age: torch.Tensor   # (E,) int32 ticks since the snapshot

    @property
    def snap_m(self) -> torch.Tensor:
        return self.snap[:, -1]


def init_async_buffer(n_edges: int, d: int, dtype=torch.float32,
                      device=None) -> AsyncBuffer:
    """Zero snapshots (the relay's own start, so a delivery before the
    first wake integrates nothing) at age 0."""
    return AsyncBuffer(
        snap=torch.zeros((n_edges, d + 1), dtype=dtype, device=device),
        age=torch.zeros((n_edges,), dtype=torch.int32, device=device))


def wake_rows(kt: Key, n: int, wake_prob: torch.Tensor) -> torch.Tensor:
    """Wake coins from the tick's folded key(s): one key -> (n,), K keys
    with (K,) ``wake_prob`` -> (K·n,). ``wake_prob == 1`` is all-True
    (the uniform lies in [0, 1))."""
    u = uniform(kt, n, wake_prob.device)
    return (u.reshape(-1, n) < wake_prob.reshape(-1, 1)).reshape(-1)


def wake_mask(key: Key, t: int, n: int, wake_prob, *, engine: int,
              device=None) -> torch.Tensor:
    """(n,) bool — which agents' clocks fire at tick ``t``, on the
    engine's wake stream."""
    p = torch.as_tensor(wake_prob, dtype=torch.float32, device=device)
    return wake_rows(fold_in(key, async_stream_fold(t, engine)), n, p)


# ---------------------------------------------------------------------------
# Statics contracts — one per engine that folds wake coins into its base
# key. Same discipline as the *_faults contracts: (a) async state stays an
# O(E·d) per-edge carry, no (N, N) and no (T, *) schedules but the keys of
# every round (HORIZON_KEYS); (b) the wake fold-in map is proven disjoint
# from every stream on the same base key by the shares_seed_with
# cross-links. Over the statics horizon t < 2^20 the wake band lies in
# [-(4·(2^20-1) + 3) - 2^25, -2^25], strictly below the fault band
# (-2^21 - 12·2^20, -2^21]; past t ~ 2.6e6 the two bands meet, which the
# lattice prover finds rather than assumes.
# repro_torch.statics.cli maps each name to a concrete async fixture.
# ---------------------------------------------------------------------------

_ASYNC_FORBIDDEN = {"*": (("N", "N"), ("T", "*"))}


def _async_streams(engine: int):
    return (
        _contracts.StreamDecl(
            "async-wake", lambda t, _e=engine: async_stream_fold(t, _e)),
    )


_contracts.register(_contracts.EngineContract(
    name="pushsum_async",
    forbidden=_ASYNC_FORBIDDEN,
    streams=_async_streams(ENGINE_PUSHSUM),
    shares_seed_with=("pushsum", "pushsum_sharded", "pushsum_faults"),
    exempt=(HORIZON_KEYS,),
))

_contracts.register(_contracts.EngineContract(
    name="social_async",
    forbidden=_ASYNC_FORBIDDEN,
    streams=_async_streams(ENGINE_SOCIAL),
    shares_seed_with=("social", "hps", "byzantine",
                      "social_faults", "hps_faults", "hps_async"),
    exempt=(HORIZON_KEYS,),
))

_contracts.register(_contracts.EngineContract(
    name="hps_async",
    forbidden=_ASYNC_FORBIDDEN,
    streams=_async_streams(ENGINE_HPS),
    shares_seed_with=("hps", "social", "byzantine",
                      "hps_faults", "social_faults", "social_async"),
    exempt=(HORIZON_KEYS,),
))
