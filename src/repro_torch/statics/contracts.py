"""Engine contracts — the declared structural invariants the linter enforces.

The port of ``repro.statics.contracts``. Every engine declares its
invariants ONCE at its definition site with the :func:`contract`
decorator (or a direct :func:`register` call):

    @statics_contract(
        name="social",
        forbidden={"*": (("N", "N"),), "final": (("T", "*"),)},
        streams=(("link", lambda t: social_stream_fold(t, STREAM_LINK)),
                 ("signal", lambda t: social_stream_fold(t, STREAM_SIGNAL))),
        exempt=(HORIZON_KEYS,),
    )
    def _social_scan_core(...):

The decorator is transparent — it registers the declaration and returns
the function unchanged. Checks pull declarations from :data:`REGISTRY`;
the CLI (:mod:`repro_torch.statics.cli`) maps each registered name to a
small concrete fixture and runs the full registry over it.

Declaration vocabulary:

* ``forbidden`` — symbolic shape patterns (see
  :func:`repro_torch.statics.dense.find_forbidden`) keyed by ``store``
  variant; the ``"*"`` key applies to every variant.
* ``exempt`` — named exemptions from the patterns led by ``"T"``
  (:data:`repro_torch.statics.dense.EXEMPTIONS`): the port's
  horizon-major key words and coins.
* ``streams`` — ``(name, fold)`` pairs, one per PRNG stream the engine
  folds into its base key each iteration. The stream-domain analyzer fits
  each ``fold`` to an affine map over ``t`` and proves pairwise
  disjointness over ``horizon`` (:mod:`repro_torch.statics.streams`).
* ``shares_seed_with`` — names of OTHER registered engines whose streams
  must also stay disjoint from this one's, because one experiment seed may
  root both engines' base keys (the HPS link stream against the social
  streams; the fault and async bands against their host engine's).

The reference's ``caches`` (its compiled-program caches, for the retrace
sentinel) has no counterpart: the port's eager loops compile nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

__all__ = [
    "DEFAULT_HORIZON",
    "StreamDecl",
    "EngineContract",
    "REGISTRY",
    "contract",
    "register",
    "get",
    "all_contracts",
]

# The default horizon disjointness is proven over: far beyond any run the
# engines make (T <= ~1e3) while keeping every affine image well inside
# the signed-int32 fold-in space the proof requires.
DEFAULT_HORIZON = 1 << 20


@dataclasses.dataclass(frozen=True)
class StreamDecl:
    """One per-iteration PRNG stream: ``fold(t)`` is the value folded into
    the engine's base key at iteration ``t``."""

    name: str
    fold: Callable[[int], int]


@dataclasses.dataclass(frozen=True)
class EngineContract:
    name: str
    forbidden: Mapping[str, tuple[tuple, ...]] = dataclasses.field(
        default_factory=dict
    )
    streams: tuple[StreamDecl, ...] = ()
    shares_seed_with: tuple[str, ...] = ()
    horizon: int = DEFAULT_HORIZON
    exempt: tuple[str, ...] = ()

    def forbidden_for(self, store: str | None) -> tuple[tuple, ...]:
        pats = tuple(self.forbidden.get("*", ()))
        if store is not None:
            pats += tuple(self.forbidden.get(store, ()))
        return pats


REGISTRY: dict[str, EngineContract] = {}


def register(c: EngineContract) -> EngineContract:
    """Insert (or replace — re-imports under importlib.reload must not
    error) a contract in the global registry."""
    REGISTRY[c.name] = c
    return c


def contract(
    *,
    name: str,
    forbidden: Mapping[str, Sequence[tuple]] | None = None,
    streams: Sequence[tuple[str, Callable[[int], int]]] = (),
    shares_seed_with: Sequence[str] = (),
    horizon: int = DEFAULT_HORIZON,
    exempt: Sequence[str] = (),
):
    """Declare an engine's static invariants at its definition site.

    Transparent: returns the decorated function unchanged, with the
    registered :class:`EngineContract` attached as
    ``fn.__statics_contract__`` for discovery.
    """
    c = EngineContract(
        name=name,
        forbidden={k: tuple(tuple(p) for p in v)
                   for k, v in (forbidden or {}).items()},
        streams=tuple(StreamDecl(n, f) for n, f in streams),
        shares_seed_with=tuple(shares_seed_with),
        horizon=horizon,
        exempt=tuple(exempt),
    )
    register(c)

    def deco(fn):
        fn.__statics_contract__ = c
        return fn

    return deco


def get(name: str) -> EngineContract:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no statics contract named {name!r}; registered: "
            f"{sorted(REGISTRY)}"
        ) from None


def all_contracts() -> list[EngineContract]:
    return [REGISTRY[k] for k in sorted(REGISTRY)]
