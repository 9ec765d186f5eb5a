"""Serve-step builders and request retry: the port of
``repro.distributed.server``.

:class:`RetryPolicy` / :func:`call_with_retry` give the request level a
bounded, jittered exponential backoff: a transient failure at the serving
tier shows up as a timed-out or erroring request, and the caller retries
it instead of failing the batch. The schedule is the reference's, so the
same policy, clock and ``random.Random`` seed sleep the same delays.

The step builders close over the config, the kernel ``backend`` and,
for prefill, the cache capacity. With ``mesh=`` (a ``DeviceMesh`` or
:class:`~repro_torch.distributed.sharding.RankMesh`, one process a rank)
they are the reference's mesh-taking forms under ``serve_shardings``'
layout: each rank serves its rows of the request batch (split over pod
and data) on its model blocks of the parameters (the Megatron layout;
:func:`~repro_torch.models.model.init_local_params`), its cache holds its
blocks under ``cache_specs`` (its KV heads, or its block of the ring's rows
where the KV heads do not split, its RWKV6 heads, its RG-LRU channels),
and the vocabulary-split logits are gathered for the argmax. Every family
serves over the model axis: the attention decoders, RWKV6, the RG-LRU
hybrid, Whisper, InternVL2 and the parallel blocks, on whole or split
heads and vocabularies (:mod:`repro_torch.models.model_axis`). A decode
step over a cache whose K/V rings are split over their rows is given the
``cache_len`` its prefill step was given.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable

from ..configs.base import ArchConfig
from ..models import model as M
from ..models.model_axis import ModelAxis, check_model_axis
from .comm import Comm
from .sharding import RankMesh, batch_axes, cache_specs, param_specs

__all__ = ["RequestTimeout", "RetriesExhausted", "RetryPolicy",
           "call_with_retry", "make_prefill_step", "make_decode_step",
           "serve_shardings", "rank_rows"]


class RequestTimeout(Exception):
    """A single request attempt exceeded ``RetryPolicy.timeout``."""


class RetriesExhausted(Exception):
    """All ``RetryPolicy.max_attempts`` attempts failed; carries the last
    underlying exception as ``__cause__``."""


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with per-request timeout and jittered exponential
    backoff.

    Attempt ``k`` (0-based) that fails sleeps ``base_delay * backoff**k``
    scaled by a uniform jitter in ``[1 - jitter, 1 + jitter]``, capped at
    ``max_delay``, so a burst of simultaneous failures does not
    resynchronize into a retry stampede. A ``timeout`` of ``None`` disables
    the per-attempt deadline.
    """

    max_attempts: int = 3
    timeout: float | None = 1.0     # seconds per attempt
    base_delay: float = 0.05        # first backoff sleep
    backoff: float = 2.0            # multiplier per failed attempt
    max_delay: float = 2.0          # backoff cap
    jitter: float = 0.5             # +/- fraction of the nominal delay
    retry_on: tuple[type[BaseException], ...] = (Exception,)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got "
                             f"{self.max_attempts}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")

    def delay(self, attempt: int, rng: random.Random) -> float:
        nominal = min(self.base_delay * self.backoff ** attempt,
                      self.max_delay)
        lo = 1.0 - self.jitter
        return nominal * (lo + (1.0 + self.jitter - lo) * rng.random())


def call_with_retry(
    fn: Callable[[], Any],
    policy: RetryPolicy = RetryPolicy(),
    *,
    clock: Callable[[], float] = time.monotonic,
    sleep: Callable[[float], None] = time.sleep,
    rng: random.Random | None = None,
    on_retry: Callable[[int, BaseException], None] | None = None,
):
    """Run ``fn()`` under ``policy``; return its value or raise
    :class:`RetriesExhausted`.

    ``clock`` / ``sleep`` / ``rng`` are injectable so tests drive the
    schedule with a fake clock. The per-attempt timeout is cooperative —
    checked against ``clock()`` after ``fn`` returns — because a step
    cannot be preempted mid-call, but a stuck attempt must still count as a
    failure for the retry accounting and backoff. ``on_retry(attempt,
    exc)`` fires before each backoff sleep.
    """
    rng = rng if rng is not None else random.Random()
    last: BaseException | None = None
    for attempt in range(policy.max_attempts):
        start = clock()
        try:
            out = fn()
            if (policy.timeout is not None
                    and clock() - start > policy.timeout):
                raise RequestTimeout(
                    f"attempt {attempt} took {clock() - start:.3f}s "
                    f"(> {policy.timeout}s)")
            return out
        except policy.retry_on as e:  # noqa: PERF203 — retry loop
            last = e
        if attempt + 1 < policy.max_attempts:
            if on_retry is not None:
                on_retry(attempt, last)
            sleep(policy.delay(attempt, rng))
    raise RetriesExhausted(
        f"{policy.max_attempts} attempts failed") from last


def _model_axis(cfg: ArchConfig, mesh, comm: Comm | None):
    """The model axis of ``mesh`` (None without a mesh)."""
    if mesh is None:
        return None
    rm = mesh if isinstance(mesh, RankMesh) else RankMesh(mesh)
    check_model_axis(cfg, rm.size("model"))
    return ModelAxis(comm or Comm(rm))


def rank_rows(x, mesh):
    """This rank's rows of a global request batch ``x`` (B, ...): the
    block of (pod, data), replicated over model (``serve_shardings``'
    batch spec)."""
    rm = mesh if isinstance(mesh, RankMesh) else RankMesh(mesh)
    n, i = rm.size("pod", "data"), rm.index("pod", "data")
    if x.shape[0] % n:
        raise ValueError(f"{x.shape[0]} requests do not split over {n} "
                         f"(pod, data) ranks")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def make_prefill_step(cfg: ArchConfig, cache_len: int | None = None,
                      backend: str = "auto", *, mesh=None,
                      comm: Comm | None = None):
    """``prefill_step(params, batch) -> (logits, cache)`` with
    ``batch["tokens"]`` (B, S) and, where the family takes them, the stub
    inputs ``batch["frames"]`` (audio) and ``batch["patch_embeds"]``
    (VLM). With ``mesh`` the batch is this rank's rows (:func:`rank_rows`)
    and ``params`` its model blocks; the logits come back whole."""
    tp = _model_axis(cfg, mesh, comm)

    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch["tokens"], cache_len=cache_len,
                         backend=backend,
                         patch_embeds=batch.get("patch_embeds"),
                         frames=batch.get("frames"), tp=tp)

    return prefill_step


def make_decode_step(cfg: ArchConfig, backend: str = "auto", *,
                     cache_len: int | None = None, mesh=None,
                     comm: Comm | None = None):
    """``decode_step(params, cache, token) -> (logits, cache)``; the cache
    is updated in place. With ``mesh``: this rank's rows, blocks and cache
    blocks, the logits whole; ``cache_len`` is the prefill step's (a rank's
    block of a ring split over its rows needs the ring's length; a decode
    step without it refuses such a cache)."""
    tp = _model_axis(cfg, mesh, comm)

    def decode_step(params, cache, token):
        return M.decode_step(params, cfg, cache, token, backend=backend,
                             tp=tp, cache_len=cache_len)

    return decode_step


def serve_shardings(cfg: ArchConfig, mesh, params_like, cache_like):
    """(parameter specs, cache specs, token spec) of serving on ``mesh``:
    no FSDP, the request batch over (pod, data)."""
    pspecs = param_specs(params_like, cfg, mesh, fsdp=False)
    cspecs = cache_specs(cache_like, cfg, mesh)
    b = batch_axes(mesh)
    return pspecs, cspecs, (b[0] if len(b) == 1 else b, None)
