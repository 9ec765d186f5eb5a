"""Serve-step builders and request retry: the port of
``repro.distributed.server`` without the mesh.

:class:`RetryPolicy` / :func:`call_with_retry` give the request level a
bounded, jittered exponential backoff: a transient failure at the serving
tier shows up as a timed-out or erroring request, and the caller retries
it instead of failing the batch. The schedule is the reference's, so the
same policy, clock and ``random.Random`` seed sleep the same delays.

The step builders close over the config, the kernel ``backend`` and,
for prefill, the cache capacity. Sharding the request batch over several
cards (the reference's ``serve_shardings``) waits for the multi-GPU item
(ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Any, Callable

from ..configs.base import ArchConfig
from ..models import model as M

__all__ = ["RequestTimeout", "RetriesExhausted", "RetryPolicy",
           "call_with_retry", "make_prefill_step", "make_decode_step"]


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


def make_prefill_step(cfg: ArchConfig, cache_len: int | None = None,
                      backend: str = "auto"):
    """``prefill_step(params, batch) -> (logits, cache)`` with
    ``batch["tokens"]`` (B, S) and, where the family takes them, the stub
    inputs ``batch["frames"]`` (audio) and ``batch["patch_embeds"]``
    (VLM)."""
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch["tokens"], cache_len=cache_len,
                         backend=backend,
                         patch_embeds=batch.get("patch_embeds"),
                         frames=batch.get("frames"))

    return prefill_step


def make_decode_step(cfg: ArchConfig, backend: str = "auto"):
    """``decode_step(params, cache, token) -> (logits, cache)``; the cache
    is updated in place."""
    def decode_step(params, cache, token):
        return M.decode_step(params, cfg, cache, token, backend=backend)

    return decode_step
