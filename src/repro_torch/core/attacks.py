"""Byzantine attack strategies.

The system adversary (Section II-B) has full knowledge of the system state,
may collude, and uses *point-to-point* communication: a Byzantine sender may
transmit different values to different receivers.

The port of ``repro.core.attacks``. Two interfaces coexist, keyed to the
two gossip cores:

* ``messages(key, t, r) -> (N_senders, N_receivers, m, m)`` — the dense
  tensor the (N, N)-broadcast oracle consumes. O(N^2) by construction.
* ``nbr_messages(key, t, r, nbr_idx) -> nbr_idx.shape + r.shape[1:]`` — the
  sparse form: the value slot ``(j, k)`` of the padded neighbor list
  receives from sender ``nbr_idx[j, k]``. For deterministic attacks the two
  forms agree exactly (``nbr_messages(...)[j, k] ==
  messages(...)[nbr_idx[j, k], j]``); ``random_noise`` draws per slot
  instead of per (sender, receiver) — same distribution, different stream.
  ``r`` may carry any trailing pair shape ((m, m) pairwise, (m,)
  one-vs-rest); attacks broadcast over it.
* the same ``nbr_messages`` over K scenarios at once: ``key`` a key of K
  numpy words, ``r`` (K, N, *pair), ``nbr_idx`` (K, R, deg_max) -> (K, R,
  deg_max, *pair). Scenario k's rows are what the single-scenario call
  gives on its own ``r[k]`` and key ``k``, bit for bit: ``sign_flip``'s
  mean and ``extreme_pull``'s max reduce over that scenario's N agents,
  and ``random_noise`` draws from that scenario's key.

A broadcast attack returns a stride-0 ``expand`` view, not a copy, so the
per-round (N, deg_max, P) message tensor costs no memory traffic; the trim
kernel reads it through its strides. Over K scenarios a value that differs
per scenario cannot be one stride of the flattened (K R, deg_max, P)
tensor, so it is written once per receiver, (K R, P), and expanded over
the slots with stride 0 (4.7 MB a round at 131,072 receivers and P = 9,
against 33 MB for every slot); a constant lie stays all stride 0. ``key`` is a
:class:`~repro_torch.core.prng.Key` and ``t`` the host iteration count, so
``random_noise`` draws the reference's uniforms bit for bit. A lie comes
out in ``r``'s dtype, except ``random_noise``'s float32 draws, which the
engine casts to the storage dtype as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .prng import Key, fold_in, normal

__all__ = ["Attack", "sign_flip", "large_value", "random_noise",
           "extreme_pull", "truth_suppression", "ATTACKS"]

# messages(key, t, r) -> (N, N, m, m); ps_reply(key, t, r) -> (N, m, m)
MsgFn = Callable[[Key, int, torch.Tensor], torch.Tensor]
ReplyFn = Callable[[Key, int, torch.Tensor], torch.Tensor]
# nbr_messages(key, t, r, nbr_idx) -> nbr_idx.shape + r.shape[1:]
NbrMsgFn = Callable[[Key, int, torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Attack:
    """A Byzantine strategy. ``name`` is used by benchmarks/tests."""

    name: str
    messages: MsgFn
    ps_reply: ReplyFn
    nbr_messages: NbrMsgFn | None = None


def _broadcast_reply(msg_fn: MsgFn) -> ReplyFn:
    """Default PS reply: what the agent would send on a self-link."""

    def reply(key, t, r):
        full = msg_fn(key, t, r)  # (N, N, m, m)
        ar = torch.arange(full.shape[0], device=full.device)
        return full[ar, ar]

    return reply


def _lead(nbr_idx: torch.Tensor) -> int:
    """1 for the K-scenario form (a (K, R, deg_max) index), else 0."""
    return nbr_idx.dim() - 2


def _per_slot(val: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """``val`` (*pair), or (K, *pair) with one value a scenario, at every
    slot of ``nbr_idx``: stride 0 over the slots, and over the receivers
    too where there is one scenario; K > 1 scenarios write one row a
    receiver."""
    if not _lead(nbr_idx):
        return val.expand(tuple(nbr_idx.shape) + tuple(val.shape))
    K, R, dm = nbr_idx.shape
    pair = tuple(val.shape[1:])
    rows = val[:, None].expand((K, R) + pair).reshape((K * R,) + pair)
    return rows.view((K, R, 1) + pair).expand((K, R, dm) + pair)


def _broadcast_nbr(val_fn) -> NbrMsgFn:
    """Sparse form of a broadcast attack: one value (a scenario), every
    slot."""

    def nbr_messages(key, t, r, nbr_idx):
        return _per_slot(val_fn(r, _lead(nbr_idx)), nbr_idx)

    return nbr_messages


def _broadcast(val: torch.Tensor, n: int) -> torch.Tensor:
    return val.expand((n, n) + tuple(val.shape))


def sign_flip(scale: float = 2.0) -> Attack:
    """Send the negated (scaled) average of the normal agents' states.

    A colluding attack: all Byzantine agents push the consensus toward the
    mirror image of the honest average.
    """

    def val(r, lead=0):
        # the mean in float32, rounded once to r's dtype, as jnp.mean of a
        # half-precision r takes it
        return -scale * r.mean(dim=lead, dtype=torch.float32).to(r.dtype)

    def messages(key, t, r):
        return _broadcast(val(r), r.shape[0])

    return Attack("sign_flip", messages, _broadcast_reply(messages),
                  _broadcast_nbr(val))


def large_value(magnitude: float = 1e3) -> Attack:
    """Send a huge constant — the classic outlier attack trimming must stop."""

    def messages(key, t, r):
        n, m = r.shape[0], r.shape[-1]
        val = torch.full((), magnitude, dtype=r.dtype, device=r.device)
        return val.expand(n, n, m, m)

    def nbr_messages(key, t, r, nbr_idx):
        val = torch.full((), magnitude, dtype=r.dtype, device=r.device)
        return val.expand(tuple(nbr_idx.shape)
                          + tuple(r.shape[1 + _lead(nbr_idx):]))

    return Attack("large_value", messages, _broadcast_reply(messages),
                  nbr_messages)


def random_noise(scale: float = 50.0) -> Attack:
    """Point-to-point i.i.d. Gaussian lies — different value per receiver."""

    def messages(key, t, r):
        n, m = r.shape[0], r.shape[-1]
        return scale * normal(fold_in(key, t), (n, n, m, m), r.device)

    def nbr_messages(key, t, r, nbr_idx):
        lead = _lead(nbr_idx)
        shape = tuple(nbr_idx.shape[lead:]) + tuple(r.shape[1 + lead:])
        return scale * normal(fold_in(key, t), shape, r.device)

    return Attack("random_noise", messages, _broadcast_reply(messages),
                  nbr_messages)


def extreme_pull(offset: float = 10.0) -> Attack:
    """Sit just past the honest extremes to bias the post-trim window."""

    def val(r, lead=0):
        return r.max(dim=lead).values + offset

    def messages(key, t, r):
        return _broadcast(val(r), r.shape[0])

    return Attack("extreme_pull", messages, _broadcast_reply(messages),
                  _broadcast_nbr(val))


def truth_suppression(truth: int, magnitude: float = 1e3) -> Attack:
    """Targeted attack: claim overwhelming evidence *against* theta*.

    For every pair (theta*, theta) send -magnitude, for (theta, theta*) send
    +magnitude — i.e. pretend every other hypothesis dominates the truth.
    The adversary knows theta* (full-knowledge threat model). The attack
    needs the pairwise (m, m) statistic structure; on one-vs-rest dynamics
    it degrades to silence (zeros), matching the dense lowering's behaviour
    when the pair axis is squeezed away.
    """

    def _pair_val(m, r):
        val = torch.zeros((m, m), dtype=r.dtype, device=r.device)
        if m > truth:   # jax drops the out-of-range writes of a smaller m
            val[truth, :] = -magnitude
            val[:, truth] = magnitude
            val[truth, truth] = 0.0
        return val

    def messages(key, t, r):
        n, m = r.shape[0], r.shape[-1]
        return _pair_val(m, r).expand(n, n, m, m)

    def nbr_messages(key, t, r, nbr_idx):
        pair = tuple(r.shape[1 + _lead(nbr_idx):])
        if len(pair) == 2 and pair[0] == pair[1]:
            val = _pair_val(pair[0], r)
        else:
            val = torch.zeros(pair, dtype=r.dtype, device=r.device)
        return val.expand(tuple(nbr_idx.shape) + pair)

    return Attack("truth_suppression", messages, _broadcast_reply(messages),
                  nbr_messages)


ATTACKS = {
    "sign_flip": sign_flip,
    "large_value": large_value,
    "random_noise": random_noise,
    "extreme_pull": extreme_pull,
    "truth_suppression": truth_suppression,
}
