"""PRNG stream-domain analyzer — exact disjointness proofs for fold-in maps.

The port of ``repro.statics.streams``, unchanged in substance: it is pure
integer arithmetic. Every engine derives its per-iteration PRNG streams by
folding a small integer into one base key: ``fold_in(key, f(t))``.
Independence of the streams rests on the fold-in maps having *disjoint
images* over the run horizon; ad-hoc schemes (``t`` / ``2t+1`` / ``2t+2``;
``t`` twice; plain ``t`` against ``2t+s``) have silently intersected
before, and :data:`LEGACY_BUGGY_STREAMS` keeps those three.

Every map in the port is affine, ``f(t) = a*t + b`` (including the HPS
``~t`` domain, ``~t = -t - 1``, and the fault and async bands, whose
``np.int32`` words are affine over the horizon), so disjointness over a
horizon is an exactly decidable integer-lattice problem, not a property
test:

    a1*t1 + b1 = a2*t2 + b2,  t1 in [0, T1),  t2 in [0, T2)

is a linear Diophantine equation; Bezout gives the full solution family
and intersecting the box constraints decides it — producing the colliding
``(t1, t2)`` WITNESS when the verdict is "not disjoint".

Soundness domain: ``fold_in`` consumes the value mod 2^32, and the signed
range (-2^31, 2^31) maps injectively into uint32 space, so integer
disjointness implies fold-in disjointness as long as every image stays in
that range over the horizon — :func:`affine_disjoint` checks this bound
and refuses (loudly) rather than answer outside it.

:func:`fit_affine` recovers ``(a, b)`` from the engine's actual fold
callable by probing it at several ``t`` and verifying affinity, so the
declared contract can never drift from the shipped code.
"""
from __future__ import annotations

import dataclasses
from math import gcd
from typing import Callable, Sequence

import numpy as np

from .dense import Finding

__all__ = [
    "AffineMap",
    "fit_affine",
    "affine_disjoint",
    "check_streams",
    "brute_force_disjoint",
    "LEGACY_BUGGY_STREAMS",
]

# fold_in consumes values mod 2^32; (-2^31, 2^31) signed maps injectively
# into that space, so images confined to it keep the integer proof sound.
_FOLD_BOUND = 1 << 31


@dataclasses.dataclass(frozen=True)
class AffineMap:
    """``t -> a*t + b`` over the integer iteration index."""

    name: str
    a: int
    b: int

    def __call__(self, t: int) -> int:
        return self.a * t + self.b

    def image_bound(self, T: int) -> int:
        """max |value| over t in [0, T)."""
        return max(abs(self.b), abs(self.a * (T - 1) + self.b))

    def __str__(self) -> str:
        return f"{self.name}: t -> {self.a}*t + {self.b}"


def fit_affine(
    fold: Callable[[int], int],
    name: str,
    probes: Sequence[int] = (0, 1, 2, 7, 129, 4099),
) -> AffineMap:
    """Recover the affine coefficients of an engine's fold callable.

    Probes at several ``t``; a map that is not affine over the probes (the
    analyzer's soundness assumption) is rejected rather than approximated.
    Numpy scalar returns (``~np.int32(t)``) are normalized to Python ints.
    """
    ys = [int(np.asarray(fold(int(t)))) for t in probes]
    a = ys[1] - ys[0]
    b = ys[0]
    for t, y in zip(probes, ys):
        if a * int(t) + b != y:
            raise ValueError(
                f"stream {name!r}: fold map is not affine over probes "
                f"{tuple(probes)} (got {ys}); the lattice analyzer cannot "
                "certify it — extend repro_torch.statics.streams first"
            )
    return AffineMap(name=name, a=a, b=b)


def _k_range(t0: int, step: int, hi: int) -> tuple[int, int] | None:
    """Integer k with 0 <= t0 + step*k < hi, as an inclusive (lo, hi) range.

    ``None`` means empty; ``step == 0`` collapses to all-k or none.
    """
    if step == 0:
        return (None if not (0 <= t0 < hi) else (-(1 << 62), 1 << 62))
    # 0 <= t0 + step*k <= hi - 1, solved with exact ceil/floor division
    # (Python's // floors toward -inf, so ceil(p/q) = -((-p) // q) for q > 0)
    if step > 0:
        lo_k = -(t0 // step)                     # ceil(-t0 / step)
        hi_k = (hi - 1 - t0) // step             # floor((hi-1-t0)/step)
    else:
        s = -step
        lo_k = -((hi - 1 - t0) // s)             # ceil((t0-(hi-1))/s)
        hi_k = t0 // s                           # floor(t0 / s)
    if lo_k > hi_k:
        return None
    return (lo_k, hi_k)


def affine_disjoint(
    m1: AffineMap,
    m2: AffineMap,
    T: int,
    T2: int | None = None,
) -> tuple[bool, tuple[int, int, int] | None]:
    """Decide image disjointness of two affine maps over bounded horizons.

    Returns ``(True, None)`` if ``{m1(t1)} ∩ {m2(t2)} = ∅`` for
    ``t1 in [0, T)``, ``t2 in [0, T2 or T)``; else ``(False, witness)``
    with ``witness = (t1, t2, value)`` the smallest-``t1`` collision.
    """
    T2 = T if T2 is None else T2
    if T <= 0 or T2 <= 0:
        return True, None
    for m in (m1, m2):
        if m.image_bound(max(T, T2)) >= _FOLD_BOUND:
            raise ValueError(
                f"stream {m.name!r}: image exceeds the signed fold-in "
                f"range over horizon {max(T, T2)}; the wraparound-free "
                "proof does not apply — shrink the horizon or the map"
            )
    a1, b1, a2, b2 = m1.a, m1.b, m2.a, m2.b
    c = b2 - b1
    # a1*t1 - a2*t2 = c
    if a1 == 0 and a2 == 0:
        if c != 0:
            return True, None
        return False, (0, 0, b1)
    if a1 == 0:
        # t2 = (b1 - b2) / a2
        num = b1 - b2
        if num % a2:
            return True, None
        t2 = num // a2
        if 0 <= t2 < T2:
            return False, (0, t2, b1)
        return True, None
    if a2 == 0:
        num = b2 - b1
        if num % a1:
            return True, None
        t1 = num // a1
        if 0 <= t1 < T:
            return False, (t1, 0, b2)
        return True, None

    # Normalize to A*t1 + B*t2 = c with positive-gcd Bezout coefficients
    A, B = a1, -a2
    g = gcd(A, B)
    if c % g:
        return True, None
    x0, y0 = _bezout(abs(A), abs(B))             # x0|A| + y0|B| = g
    x = x0 if A >= 0 else -x0
    y = y0 if B >= 0 else -y0
    scale = c // g
    t1p, t2p = x * scale, y * scale
    # solution family: (t1p + (B//g)*k, t2p - (A//g)*k)
    s1, s2 = B // g, -(A // g)
    r1 = _k_range(t1p, s1, T)
    r2 = _k_range(t2p, s2, T2)
    if r1 is None or r2 is None:
        return True, None
    lo = max(r1[0], r2[0])
    hi = min(r1[1], r2[1])
    if lo > hi:
        return True, None
    # choose the k minimizing t1 for a stable, smallest witness
    k = lo if s1 > 0 else hi
    t1 = t1p + s1 * k
    t2 = t2p + s2 * k
    return False, (t1, t2, a1 * t1 + b1)


def _bezout(a: int, b: int) -> tuple[int, int]:
    """(x, y) with x*a + y*b == gcd(a, b)."""
    old_r, r = a, b
    old_x, x = 1, 0
    old_y, y = 0, 1
    while r:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_x, x = x, old_x - q * x
        old_y, y = y, old_y - q * y
    return old_x, old_y


def brute_force_disjoint(
    m1: AffineMap, m2: AffineMap, T: int, T2: int | None = None
) -> bool:
    """Enumeration oracle for small boxes (property tests only)."""
    T2 = T if T2 is None else T2
    img1 = {m1(t) for t in range(T)}
    return all(m2(t) not in img1 for t in range(T2))


def check_streams(
    maps: Sequence[AffineMap],
    T: int,
    *,
    where: str = "<streams>",
) -> list[Finding]:
    """Pairwise disjointness over the horizon; one finding per collision,
    carrying the exact ``(t, stream)`` witness."""
    out: list[Finding] = []
    for i, m1 in enumerate(maps):
        for m2 in maps[i + 1:]:
            disjoint, wit = affine_disjoint(m1, m2, T)
            if not disjoint:
                t1, t2, val = wit
                out.append(Finding(
                    check="prng-stream-collision",
                    where=where,
                    message=(
                        f"streams collide: {m1.name}@t={t1} == "
                        f"{m2.name}@t={t2} (both fold {val}); maps "
                        f"[{m1}] vs [{m2}] over horizon T={T}"
                    ),
                ))
    return out


# Three aliasing schemes the engines once had, kept importable for the
# would-have-caught regression tests ONLY. Each is an engine's buggy
# fold-in maps:
#
#   byzantine: signal t, gossip 2t+1, fusion 2t+2
#              -> signal@3 == gossip@1 == 3
#   social:    link t, signal t (both plain)
#              -> link@0 == signal@0 == 0
#   hps:       link t, aliasing social's link 2t+0
#              -> hps@0 == social-link@0 == 0
LEGACY_BUGGY_STREAMS: dict[str, tuple[AffineMap, ...]] = {
    "byzantine": (
        AffineMap("signal", 1, 0),
        AffineMap("gossip", 2, 1),
        AffineMap("fusion", 2, 2),
    ),
    "social": (
        AffineMap("link", 1, 0),
        AffineMap("signal", 1, 0),
    ),
    "hps": (
        AffineMap("hps-link", 1, 0),
    ),
}
