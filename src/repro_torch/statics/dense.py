"""Dense-intermediate linter + subnormal-constant check.

The engines' scaling guarantee is structural: the sparse engines must
never materialize an (N, N, ...) value, and the in-loop-reducing ``store``
variants must never materialize a (T, ...) value. Both are one pass over
:func:`repro_torch.statics.walk.collect_values`.

Patterns are symbolic shape *prefixes* over the fixture's dim table:
``("N", "N")`` flags any value whose first two axes are both N;
``("T", "*")`` flags any rank >= 2 value led by the horizon axis (``"*"``
matches any single axis). Engines declare their patterns per ``store``
variant via :func:`repro_torch.statics.contracts.contract`.

**The one exemption, :data:`HORIZON_KEYS`.** The port folds every round's
PRNG keys on the host before its loop and draws the parameter server's
coins for all rounds at once (:func:`repro_torch.core.prng.fold_rounds`,
:func:`repro_torch.core.faults.ps_alive_rounds`), so its programs hold
(T, K, 1) int64 key words and (T, K) bool coins that the reference's scan
draws round by round. A contract may name this exemption; it spares a
value matched by a pattern led by ``"T"`` only when the value is integer
or bool, and every axis after T is a constant (no fixture symbol) whose
product is at most :data:`KEY_WIDTH_CAP` — one key's two words. A (T, N)
or (T, E) value, of any dtype, is still caught; so is every (N, N).

:func:`find_subnormal_consts` is the would-have-caught check for the
belief-floor bug: a literal like ``1e-38`` sits below the smallest normal
float32 (~1.1754944e-38), so a flush-to-zero backend turns
``log(max(mu, 1e-38))`` into ``log(0) = -inf``. Any float literal in the
subnormal range of the dtype it is computed in is flagged.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .walk import collect_literals, collect_values, symbolize

__all__ = ["Finding", "HORIZON_KEYS", "KEY_WIDTH_CAP", "EXEMPTIONS",
           "find_forbidden", "assert_nonempty", "find_subnormal_consts"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation; ``check`` names the pass, ``where`` the engine /
    entry point the recorded program came from."""

    check: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"[{self.check}] {self.where}: {self.message}"


HORIZON_KEYS = "horizon-major-keys"
KEY_WIDTH_CAP = 2


def _horizon_key(val, sym: tuple) -> bool:
    """A (T, c...) integer or bool value of a constant trailing width."""
    trailing = sym[1:]
    return (len(sym) >= 2 and sym[0] == "T"
            and not val.dtype.is_floating_point
            and not val.dtype.is_complex
            and all(isinstance(a, int) for a in trailing)
            and math.prod(trailing) <= KEY_WIDTH_CAP)


#: exemption name -> predicate(value, symbolized shape)
EXEMPTIONS = {HORIZON_KEYS: _horizon_key}


def _matches(sym_shape: tuple, pattern: tuple) -> bool:
    """Anchored prefix match with ``"*"`` single-axis wildcard."""
    if len(sym_shape) < len(pattern):
        return False
    for got, want in zip(sym_shape, pattern):
        if want != "*" and got != want:
            return False
    return True


def _exempt(val, sym: tuple, pattern: tuple, exempt: tuple) -> bool:
    return pattern[:1] == ("T",) and any(EXEMPTIONS[e](val, sym)
                                         for e in exempt)


def find_forbidden(
    record,
    dims: dict[str, int],
    patterns: tuple[tuple, ...],
    *,
    where: str = "<traced fn>",
    exempt: tuple[str, ...] = (),
) -> list[Finding]:
    """Flag every recorded value whose symbolized shape starts with a
    forbidden pattern, but for the named ``exempt`` classes
    (:data:`EXEMPTIONS`). ``dims`` maps fixture symbols to the concrete
    sizes the program ran at (pairwise-distinct; see
    :func:`repro_torch.statics.walk.symbolize`)."""
    for e in exempt:
        if e not in EXEMPTIONS:
            raise KeyError(f"unknown exemption {e!r}; known: "
                           f"{sorted(EXEMPTIONS)}")
    out: list[Finding] = []
    for val in collect_values(record):
        sym = symbolize(val.shape, dims)
        for pat in patterns:
            if _matches(sym, pat) and not _exempt(val, sym, pat, exempt):
                out.append(Finding(
                    check="dense-intermediate",
                    where=where,
                    message=(
                        f"forbidden {pat} value: {val.describe(dims)} "
                        f"(concrete shape {val.shape})"
                    ),
                ))
                break
    return out


def assert_nonempty(record, *, where: str = "<traced fn>") -> list[Finding]:
    """A record with no values means the recorder saw nothing — the
    program ran outside it, or was a constant."""
    if collect_values(record):
        return []
    return [Finding(
        check="dense-intermediate", where=where,
        message="the op recorder found no values (empty program?)",
    )]


def find_subnormal_consts(record, *,
                          where: str = "<traced fn>") -> list[Finding]:
    """Flag float literals in the subnormal range of their own dtype."""
    out: list[Finding] = []
    for lit in collect_literals(record):
        tiny = torch.finfo(lit.dtype).tiny
        vals = np.atleast_1d(lit.values)
        bad = vals[(vals != 0) & np.isfinite(vals) & (np.abs(vals) < tiny)]
        if bad.size:
            dt = str(lit.dtype).replace("torch.", "")
            out.append(Finding(
                check="subnormal-const",
                where=where,
                message=(
                    f"literal {float(bad.ravel()[0])!r} at {lit.op} is "
                    f"subnormal for {dt} (tiny={tiny!r}); a flush-to-zero "
                    "backend reads it as 0.0 — use the dtype's smallest "
                    "NORMAL value instead (the belief-floor NaN class)"
                ),
            ))
    return out
